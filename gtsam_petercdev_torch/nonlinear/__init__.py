"""gtsam_petercdev_torch.nonlinear"""
