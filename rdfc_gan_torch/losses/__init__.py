from .gan_loss import (GANLoss, binary_cross_entropy_loss, gradient_penalty,
                       l1_loss, l2_loss, mse_loss, norm_normalize)

__all__ = ["GANLoss", "binary_cross_entropy_loss", "gradient_penalty",
           "l1_loss", "l2_loss", "mse_loss", "norm_normalize"]
