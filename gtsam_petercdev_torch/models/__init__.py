"""gtsam_petercdev_torch.models"""
