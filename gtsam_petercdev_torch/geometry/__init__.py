"""gtsam_petercdev_torch.geometry"""
