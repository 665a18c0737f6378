"""Losses (port of ag2video_tpu/losses): the GAN losses, the VGG perceptual
loss and the three loss modes of the reference's LossModel (graph,
generator, discriminator)."""

from ag2video_torch.losses.gan import (  # noqa: F401
    gan_loss, get_gan_losses, multiscale_gan_loss)
from ag2video_torch.losses.loss_model import (  # noqa: F401
    compute_discriminator_loss, compute_generator_loss, compute_graph_loss)
from ag2video_torch.losses.perceptual import vgg_loss  # noqa: F401
