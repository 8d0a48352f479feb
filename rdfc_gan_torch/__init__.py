"""rdfc_gan_torch — the PyTorch/CUDA port of rdfc_gan_tpu for NVIDIA H100.

Slice 1: the RDF-GAN NLSPN serving path (``python -m rdfc_gan_torch.test``).
Slice 2: its train step, G and the PatchGAN D (``python -m
rdfc_gan_torch.train``). Slice 3: the flagship RDFC-GAN served (G_label ->
G_normal -> G_A2B, ``python -m rdfc_gan_torch.test`` on
``configs/rdf_cycle_patchgan_config.yaml``). Hand-written CUDA kernels
(``csrc/``) carry the NLSPN shift-mask scatter and gather, the propagation
chain with and without its input stack, the reverse gradient chain, the
shift correlation, and the instance norm with its backward. Imports torch,
never JAX.
"""
