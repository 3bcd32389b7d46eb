"""gtsam_petercdev_torch.sfm"""
