from .gan_loss import (GANLoss, binary_cross_entropy_loss, gradient_penalty,
                       l1_loss, l2_loss, manhattan_loss, mse_loss, nor_loss,
                       norm_normalize, softmax_cross_entropy_loss)

__all__ = ["GANLoss", "binary_cross_entropy_loss", "gradient_penalty",
           "l1_loss", "l2_loss", "manhattan_loss", "mse_loss", "nor_loss",
           "norm_normalize", "softmax_cross_entropy_loss"]
