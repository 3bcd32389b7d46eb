"""gtsam_petercdev_torch.parallel"""
