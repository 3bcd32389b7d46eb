"""gtsam_petercdev_torch.hybrid"""
