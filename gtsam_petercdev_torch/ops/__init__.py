"""gtsam_petercdev_torch.ops"""
