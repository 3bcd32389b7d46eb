"""gtsam_petercdev_torch.core"""
