"""gtsam_petercdev_torch.discrete"""
