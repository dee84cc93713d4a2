"""ViT-B/16 image frontend (PyTorch port of ``vln_ver_tpu/models/vit.py``).

The reference lifts precomputed ViT-B/16 patch features
(``new_vit_base_patch16_197_imagenet.hdf5``, voxelformer.py:317-325:
``{scan}_{vp}_i{cam}_{deg}`` -> (1, 197, 768), CLS at row 0).  This module
computes them: a pre-LN ViT whose module and parameter names are
HuggingFace ``ViTModel``'s, so an HF state dict loads by name
(:func:`~vln_ver_tpu_torch.convert.vit.load_hf_vit_state_dict`) and the
JAX ViT's weights carry across
(:func:`~vln_ver_tpu_torch.convert.vit.vit_state_dict_from_jax`).

  Conv2d patch embedding (stride = patch) -> prepend CLS -> + positions ->
  N x [LN -> MHA -> residual; LN -> MLP (exact GELU) -> residual] -> LN.

Inference only (the HF defaults have no dropout).  The parameters are
fp32; the compute runs in ``dtype`` as the rest of the port does (LayerNorm
statistics and the attention scores and softmax in fp32), and an fp32 ViT
runs its convolution and GEMMs in true fp32 (``runtime.fp32_precision``).
The ViT is no Pallas kernel in the JAX package: plain PyTorch here,
cuBLAS and cuDNN on the card.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..runtime import fp32_precision
from .layers import Dense, LayerNorm

# LayerNorm eps of HF's ViTConfig (and of the JAX ViT)
VIT_LN_EPS = 1e-12


class PatchProjection(nn.Module):
    """``nn.Conv2d(3, C, patch, stride=patch)`` on NCHW images in
    ``dtype``, with fp32 parameters ``weight`` (C, 3, p, p) and ``bias``."""

    def __init__(self, channels: int, patch_size: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.patch_size = patch_size
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(channels, 3, patch_size,
                                               patch_size))
        self.bias = nn.Parameter(torch.empty(channels))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        # flax lecun_normal on the (p, p, 3, C) kernel: fan-in 3 p^2
        std = math.sqrt(1.0 / self.weight[0].numel()) / .87962566103423978
        nn.init.trunc_normal_(self.weight, std=std, a=-2 * std, b=2 * std,
                              generator=generator)
        self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        return F.conv2d(x.to(dt), self.weight.to(dt), self.bias.to(dt),
                        stride=self.patch_size)


class _PatchEmbeddings(nn.Module):
    def __init__(self, channels, patch_size, dtype):
        super().__init__()
        self.projection = PatchProjection(channels, patch_size, dtype)


class ViTEmbeddings(nn.Module):
    def __init__(self, channels: int, patch_size: int, num_patches: int,
                 dtype: torch.dtype):
        super().__init__()
        self.cls_token = nn.Parameter(torch.empty(1, 1, channels))
        self.position_embeddings = nn.Parameter(
            torch.empty(1, 1 + num_patches, channels))
        self.patch_embeddings = _PatchEmbeddings(channels, patch_size, dtype)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.cls_token.normal_(0.0, 0.02, generator=generator)
        self.position_embeddings.normal_(0.0, 0.02, generator=generator)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """(B, 3, S, S) -> (B, 1 + P, C), patches row-major."""
        x = self.patch_embeddings.projection(images)      # (B, C, s, s)
        x = x.flatten(2).transpose(1, 2)                  # (B, P, C)
        cls = self.cls_token.to(x.dtype).expand(x.shape[0], -1, -1)
        return torch.cat([cls, x], dim=1) + self.position_embeddings.to(
            x.dtype)


class ViTSelfAttention(nn.Module):
    def __init__(self, channels: int, num_heads: int, dtype: torch.dtype):
        super().__init__()
        self.num_heads = num_heads
        self.query = Dense(channels, channels, dtype)
        self.key = Dense(channels, channels, dtype)
        self.value = Dense(channels, channels, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        hd = c // self.num_heads

        def heads(t):
            return t.reshape(b, n, self.num_heads, hd).transpose(1, 2)

        q, k, v = heads(self.query(x)), heads(self.key(x)), heads(self.value(x))
        # q scaled before the product, as flax's dot_product_attention
        scores = (q.float() / math.sqrt(hd)) @ k.float().transpose(-1, -2)
        probs = scores.softmax(dim=-1)
        return (probs.to(v.dtype) @ v).transpose(1, 2).reshape(b, n, c)


class _SelfOutput(nn.Module):
    def __init__(self, channels, dtype):
        super().__init__()
        self.dense = Dense(channels, channels, dtype)


class ViTAttention(nn.Module):
    def __init__(self, channels: int, num_heads: int, dtype: torch.dtype):
        super().__init__()
        self.attention = ViTSelfAttention(channels, num_heads, dtype)
        self.output = _SelfOutput(channels, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.output.dense(self.attention(x))


class _Intermediate(nn.Module):
    def __init__(self, channels, ffn_dim, dtype):
        super().__init__()
        self.dense = Dense(channels, ffn_dim, dtype)


class _Output(nn.Module):
    def __init__(self, channels, ffn_dim, dtype):
        super().__init__()
        self.dense = Dense(ffn_dim, channels, dtype)


class ViTLayer(nn.Module):
    def __init__(self, channels: int, num_heads: int, ffn_dim: int,
                 dtype: torch.dtype):
        super().__init__()
        self.attention = ViTAttention(channels, num_heads, dtype)
        self.intermediate = _Intermediate(channels, ffn_dim, dtype)
        self.output = _Output(channels, ffn_dim, dtype)
        self.layernorm_before = LayerNorm(channels, dtype, eps=VIT_LN_EPS)
        self.layernorm_after = LayerNorm(channels, dtype, eps=VIT_LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attention(self.layernorm_before(x))
        y = F.gelu(self.intermediate.dense(self.layernorm_after(x)))
        return x + self.output.dense(y)


class _Encoder(nn.Module):
    def __init__(self, num_layers, channels, num_heads, ffn_dim, dtype):
        super().__init__()
        self.layer = nn.ModuleList([
            ViTLayer(channels, num_heads, ffn_dim, dtype)
            for _ in range(num_layers)])


class ViT(nn.Module):
    """HF ``ViTModel`` without its pooler.  ``forward`` takes (B, S, S, 3)
    images, already resized and normalised (:func:`preprocess_images`),
    channels last as the JAX ViT does, and returns the (B, 1 + P, C) token
    features in fp32, CLS first."""

    def __init__(self, image_size: int = 224, patch_size: int = 16,
                 embed_dims: int = 768, num_layers: int = 12,
                 num_heads: int = 12, ffn_dim: int = 3072,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if image_size % patch_size or embed_dims % num_heads:
            raise ValueError(
                f"image_size {image_size} must divide by patch_size "
                f"{patch_size}, embed_dims {embed_dims} by num_heads "
                f"{num_heads}")
        self.image_size = image_size
        self.patch_size = patch_size
        self.embed_dims = embed_dims
        self.dtype = dtype
        self.embeddings = ViTEmbeddings(embed_dims, patch_size,
                                        self.num_patches, dtype)
        self.encoder = _Encoder(num_layers, embed_dims, num_heads, ffn_dim,
                                dtype)
        self.layernorm = LayerNorm(embed_dims, dtype, eps=VIT_LN_EPS)

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "ViT":
        """Random weights from ``generator`` with the flax initialisers'
        distributions: lecun-normal kernels with zero biases, normal(0.02)
        CLS token and positions; LayerNorms keep ones and zeros."""
        for m in self.modules():
            if isinstance(m, (Dense, PatchProjection, ViTEmbeddings)):
                m.reset_parameters(generator)
        return self

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = images.shape
        if h != self.image_size or w != self.image_size:
            raise ValueError(f"images of {h}x{w}, the ViT takes "
                             f"{self.image_size}x{self.image_size}")
        with fp32_precision(self.dtype):
            x = self.embeddings(images.permute(0, 3, 1, 2))
            for layer in self.encoder.layer:
                x = layer(x)
            return self.layernorm(x).float()


def preprocess_images(images: torch.Tensor, image_size: int = 224,
                      mean: float = 0.5, std: float = 0.5) -> torch.Tensor:
    """uint8 or float (B, H, W, 3) -> (B, S, S, 3) fp32, resized and
    normalised, on ``images``' device: ``/ 255``, an antialiased bilinear
    resize (``F.interpolate(..., antialias=True)``, the normalised
    triangle filter widened by the downscale factor that
    ``jax.image.resize(..., "bilinear", antialias=True)`` applies), then
    ``(x - mean) / std`` (timm / HF ViT-B/16: 0.5 and 0.5).  Views of
    ``image_size`` already, as the MP3D rig's 224 x 224 are, skip the
    resize."""
    x = images.float() / 255.0
    if x.shape[1] != image_size or x.shape[2] != image_size:
        x = F.interpolate(x.permute(0, 3, 1, 2), size=(image_size,
                                                       image_size),
                          mode="bilinear", align_corners=False,
                          antialias=True).permute(0, 2, 3, 1)
    return (x - mean) / std


def vit_feature_frontend(model: ViT, images_u8: torch.Tensor,
                         mean: float = 0.5, std: float = 0.5
                         ) -> torch.Tensor:
    """Raw views -> the lift's per-camera feature grid, on the views'
    device: ``images_u8`` (B, cams, H, W, 3) uint8 -> (B, cams, fh, fw, C)
    fp32, the CLS token stripped and the patches row-major, which is what
    ``MP3DDataset`` serves from the feature HDF5 (the reference drops row
    0 of (1, 197, 768), voxelformer.py:322)."""
    b, cams = images_u8.shape[:2]
    x = images_u8.reshape((b * cams,) + tuple(images_u8.shape[2:]))
    tok = model(preprocess_images(x, model.image_size, mean, std))
    fh = model.image_size // model.patch_size
    return tok[:, 1:, :].reshape(b, cams, fh, fh, model.embed_dims)


def vit_for_ver(ver, patch_size: int = 16, num_layers: int = 12,
                num_heads: int = 12, ffn_ratio: int = 4,
                dtype: torch.dtype = None) -> ViT:
    """The :class:`ViT` whose token grid is a ``VERConfig``'s feature grid:
    ``image_size = feat_h * patch_size`` and ``embed_dims =
    in_channels``.  vocc.py's config gives the reference's ViT-B/16 at 224
    (14 x 14 x 768)."""
    if ver.feat_h != ver.feat_w:
        raise ValueError(f"the ViT frontend needs a square feature grid, "
                         f"got {ver.feat_h}x{ver.feat_w}")
    return ViT(image_size=ver.feat_h * patch_size, patch_size=patch_size,
               embed_dims=ver.in_channels, num_layers=num_layers,
               num_heads=num_heads, ffn_dim=ffn_ratio * ver.in_channels,
               dtype=torch.float32 if dtype is None else dtype)
