"""gtsam_petercdev_torch.inference"""
