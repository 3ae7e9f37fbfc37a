"""High-level CLIP engine: model + weights + tokenizer behind the JAX
package's ClipEngine surface (spatially_aware_ai_tpu/models/clip/engine.py):
tiled image inference, text inference, run_query, CLIP-Surgery and the
prompt ensemble.

The engine lives on one device, the card unless `device="cpu"` is passed.
`compute_dtype` is the activation dtype of the towers (f32 by default;
bf16 optional); parameters stay f32 and embeddings come back in f32.

`img_inference_tiled_batch` always takes the fused conv stem on its
resize-once path (models/clip/tiling.py): its features are the unfused
path's bits and it writes one fewer tile tensor. The JAX package makes
the stem opt-in (SAI_FUSED_STEM=1); the port reads no such variable. The
single-frame and depth-scaled tilers stay unfused, as there.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence

import numpy as np
import torch

from ...core.device import resolve_device
from ...query import text as query_text
from .model import CLIP, CLIPConfig, VIT_B_32_QUICKGELU
from .tiling import (
    tiled_image_features,
    tiled_image_features_batch,
    tiled_image_features_depthscaled,
)
from .tokenizer import ClipTokenizer

TINY_CONFIG = CLIPConfig(
    embed_dim=32, image_size=224, patch_size=56, vision_width=64,
    vision_layers=2, vision_heads=4, vocab_size=49408, context_length=77,
    text_width=64, text_heads=4, text_layers=2,
)
# the smallest widths the card's kernels take: 64-wide heads (B5), widths a
# multiple of 64 (B2)
SMALL_CARD_CONFIG = CLIPConfig(
    embed_dim=32, image_size=224, patch_size=56, vision_width=128,
    vision_layers=2, vision_heads=2, vocab_size=49408, context_length=77,
    text_width=128, text_heads=2, text_layers=2,
)


class ClipEngine:
    def __init__(self, cfg: CLIPConfig, state_dict,
                 bpe_path: Optional[str] = None, compute_dtype=None,
                 device="cuda"):
        self.device = resolve_device(device)
        if not isinstance(cfg, CLIPConfig):  # e.g. the JAX package's config
            cfg = CLIPConfig(**dataclasses.asdict(cfg))
        self.cfg = cfg
        self.compute_dtype = compute_dtype or torch.float32
        self.model = CLIP(cfg, dtype=self.compute_dtype)
        self.model.load_state_dict(state_dict)
        self.model.to(self.device).eval().requires_grad_(False)
        self.tokenizer = ClipTokenizer(
            bpe_path or os.environ.get("SAI_BPE_VOCAB"))
        self.feature_dim = cfg.embed_dim

    # -- constructors -------------------------------------------------------

    @classmethod
    def random(cls, cfg: CLIPConfig = None, seed: int = 0,
               bpe_path: Optional[str] = None, compute_dtype=None,
               device="cuda") -> "ClipEngine":
        """Random weights from a torch.Generator seeded with `seed` (the
        JAX package's jax.random weights differ: carry those across with
        `from_jax_params`)."""
        cfg = cfg or VIT_B_32_QUICKGELU
        model = CLIP(cfg).init_random_(torch.Generator().manual_seed(seed))
        return cls(cfg, model.state_dict(), bpe_path,
                   compute_dtype=compute_dtype, device=device)

    @classmethod
    def tiny(cls, seed: int = 0, device="cuda") -> "ClipEngine":
        """The JAX package's small test config (feature_dim 32). Its heads
        are 16 wide, below the 64 that kernel B5 takes, so it runs on the
        CPU only (SMALL_CARD_CONFIG is a small config for the card)."""
        dev = resolve_device(device)
        if dev.type == "cuda":
            raise ValueError("ClipEngine.tiny has 16-wide attention heads, "
                             "which kernel B5 does not take: run it with "
                             "device='cpu'")
        return cls.random(TINY_CONFIG, seed, device=dev)

    @classmethod
    def from_jax_params(cls, cfg: CLIPConfig, params,
                        bpe_path: Optional[str] = None, compute_dtype=None,
                        device="cuda") -> "ClipEngine":
        """The JAX package's flax params carried across
        (models/clip/convert.py)."""
        from .convert import clip_state_dict_from_jax

        return cls(cfg, clip_state_dict_from_jax(params), bpe_path,
                   compute_dtype=compute_dtype, device=device)

    @classmethod
    def from_checkpoint(cls, path: str, cfg: CLIPConfig = None,
                        bpe_path: Optional[str] = None,
                        allow_fallback_vocab: bool = False,
                        compute_dtype=None, device="cuda") -> "ClipEngine":
        """Converted weights: the pickle that either package's
        cli/convert_clip writes ({"format": "sai_clip_params", "config",
        "params"}; an explicit `cfg` wins over the embedded one), or a bare
        params pickle, read as ViT-B/32 quick-gelu unless `cfg` says
        otherwise.

        Real checkpoints were trained against the standard CLIP BPE vocab
        (open_clip's bpe_simple_vocab_16e6.txt.gz); pairing them with the
        merge-free byte fallback would silently produce garbage text
        embeddings, so this constructor REQUIRES the standard vocab (via
        `bpe_path` or the SAI_BPE_VOCAB env var) unless
        `allow_fallback_vocab=True` is passed explicitly."""
        import pickle

        with open(path, "rb") as f:
            params = pickle.load(f)
        if (isinstance(params, dict)
                and params.get("format") == "sai_clip_params"):
            cfg = cfg or CLIPConfig(**params["config"])
            params = params["params"]
        engine = cls.from_jax_params(cfg or VIT_B_32_QUICKGELU, params,
                                     bpe_path, compute_dtype=compute_dtype,
                                     device=device)
        if not engine.tokenizer.has_standard_vocab:
            msg = (
                "ClipEngine.from_checkpoint: no standard BPE vocab found "
                f"(bpe_path={bpe_path!r}, SAI_BPE_VOCAB="
                f"{os.environ.get('SAI_BPE_VOCAB')!r}). Converted CLIP "
                "weights require open_clip's bpe_simple_vocab_16e6.txt.gz; "
                "the byte-level fallback tokenizer would produce garbage "
                "text embeddings. Provide the vocab file, or pass "
                "allow_fallback_vocab=True to proceed anyway (image-only "
                "use)."
            )
            if not allow_fallback_vocab:
                raise FileNotFoundError(msg)
            import warnings

            warnings.warn(msg, RuntimeWarning, stacklevel=2)
        return engine

    # -- image side ----------------------------------------------------------

    @torch.inference_mode()
    def encode_image(self, images) -> torch.Tensor:
        """images [B, 224, 224, 3] channel-normalized -> [B, C] f32."""
        return self.model.encode_image(
            torch.as_tensor(images, device=self.device))

    @torch.inference_mode()
    def img_inference_tiled(self, img, patch_size: int,
                            patch_stride: int) -> torch.Tensor:
        """One frame [H, W, 3] in [0, 1] -> [ny, nx, C] f32 feature image,
        every tile in one batch."""
        return tiled_image_features(
            torch.as_tensor(img, device=self.device),
            patch_size=patch_size, patch_stride=patch_stride,
            encode_fn=self.model.encode_image_nchw,
            prep_dtype=self.compute_dtype, vit_size=self.cfg.image_size,
        )

    def _conv_kernel(self) -> torch.Tensor:
        """conv1's weight [width, 3, p, p] (the fused stem's)."""
        return self.model.visual.conv1.weight

    @torch.inference_mode()
    def img_inference_tiled_batch(self, imgs, patch_size: int,
                                  patch_stride: int) -> torch.Tensor:
        """Frame chunk [F, H, W, 3] in [0, 1] -> [F, ny, nx, C] f32, all
        tiles in one batch; the resize-once path through the fused conv
        stem."""
        return tiled_image_features_batch(
            torch.as_tensor(imgs, device=self.device),
            patch_size=patch_size, patch_stride=patch_stride,
            encode_fn=self.model.encode_image_nchw,
            prep_dtype=self.compute_dtype,
            conv_kernel_fn=self._conv_kernel,
            encode_tokens_fn=self.model.encode_image_tokens,
            conv_patch=self.cfg.patch_size,
            vit_size=self.cfg.image_size,
        )

    @torch.inference_mode()
    def img_inference_tiled_depthscaled(self, imgs, depth, K,
                                        patch_stride: int,
                                        footprint_m: float = 0.5
                                        ) -> torch.Tensor:
        """Depth-scaled tiles (a constant physical footprint per patch):
        frames [F, H, W, 3] in [0, 1], depth [F, H, W] meters, K
        [F, 3, 3] -> [F, ny, nx, C] f32, every crop in one forward. A
        single frame ([H, W, 3], [H, W], [3, 3]) gives [ny, nx, C]."""
        imgs = torch.as_tensor(imgs, device=self.device)
        depth = torch.as_tensor(depth, dtype=torch.float32,
                                device=self.device)
        K = torch.as_tensor(K, dtype=torch.float32, device=self.device)
        one = imgs.dim() == 3
        if one:
            imgs, depth, K = imgs[None], depth[None], K[None]
        out = tiled_image_features_depthscaled(
            imgs.to(torch.float32), depth, K, patch_stride=patch_stride,
            encode_fn=self.model.encode_image_nchw, footprint_m=footprint_m,
            vit_size=self.cfg.image_size,
        )
        return out[0] if one else out

    # -- text side -----------------------------------------------------------

    @torch.inference_mode()
    def _encode_text(self, token_ids) -> torch.Tensor:
        """token_ids: [B, 77] ids, a tensor on any device or an array."""
        if not isinstance(token_ids, torch.Tensor):
            token_ids = np.asarray(token_ids)
        return self.model.encode_text(
            torch.as_tensor(token_ids, dtype=torch.int64,
                            device=self.device))

    def text_inference(self, texts: Sequence[str]) -> np.ndarray:
        """Tokenize + encode + L2 normalize -> [L, C] numpy."""
        feats = self._encode_text(self.tokenizer(list(texts)))
        feats = feats / torch.linalg.norm(feats, dim=-1, keepdim=True)
        return feats.cpu().numpy()

    def encode_text_with_prompt_ensemble(self, texts, prompt_templates=None):
        return query_text.encode_text_with_prompt_ensemble(
            self._encode_text, self.tokenizer, texts, prompt_templates,
            device=self.device,
        )

    @torch.inference_mode()
    def run_query(self, img_feats, labels: Sequence[str]) -> np.ndarray:
        """softmax(100 * img @ text^T) relevance [V, len(labels)]. img_feats
        may be a tensor on the engine's device (queried in place) or an
        array."""
        text = torch.as_tensor(self.text_inference(labels),
                               device=self.device)
        img = torch.as_tensor(img_feats, dtype=torch.float32,
                              device=self.device)
        return query_text.run_query(img, text).cpu().numpy()

    @staticmethod
    def clip_feature_surgery(image_features, text_features,
                             redundant_feats=None):
        return query_text.clip_feature_surgery(
            torch.as_tensor(image_features), torch.as_tensor(text_features),
            None if redundant_feats is None
            else torch.as_tensor(redundant_feats),
        ).cpu().numpy()
