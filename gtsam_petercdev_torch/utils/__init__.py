"""gtsam_petercdev_torch.utils"""
