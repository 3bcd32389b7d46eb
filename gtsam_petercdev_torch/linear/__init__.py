"""gtsam_petercdev_torch.linear"""
