"""gtsam_petercdev_torch.slam"""
