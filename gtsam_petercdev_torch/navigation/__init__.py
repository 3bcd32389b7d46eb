"""gtsam_petercdev_torch.navigation"""
