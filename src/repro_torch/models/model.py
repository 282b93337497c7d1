"""Top-level model API: build, init, caches, forward.

``build_model(cfg)`` returns a :class:`Model` holding the ParamDef tree;
parameters are a plain nested dict of tensors beside it (from
:meth:`Model.init` or :func:`~.params.params_from_arrays`), so the JAX
package's trees carry over key for key.  ``Model.forward`` covers the
modes the serving engine and the train step use:

* full sequence, no cache (training and evaluation, the reference decode
  is held to); ``remat=True`` recomputes the stacked layers' activations
  in the backward pass (:func:`~.transformer.stack_apply`);
* prefill — full sequence, writes the decode cache;
* decode — one token against the cache (``tokens [B, 1]``);
* encoder-decoder — frames → encoder, tokens → decoder with cross-attention.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ops import resolve_device

from .layers import apply_norm, embed_apply, embed_defs, logits_apply, norm_defs
from .params import dtype_of, init_params
from .transformer import init_stack_cache, stack_apply, stack_defs_for

__all__ = ["Model", "build_model"]


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    defs: Dict[str, Any]

    # ------------------------------------------------------------------ build
    def init(self, generator: torch.Generator, *, device=None) -> Dict[str, Any]:
        """Parameters on ``device`` (default: the card) in the config's dtype."""
        return init_params(self.defs, generator, dtype=dtype_of(self.cfg), device=device)

    # ------------------------------------------------------------------ cache
    def init_cache(self, batch: int, max_len: int, cross_len: int | None = None, *,
                   device=None) -> Dict[str, Any]:
        """Zeroed decode cache on ``device`` (default: the card).
        ``cross_len`` must equal the exact encoder output length for
        enc-dec models (padded cross keys would otherwise leak into the
        softmax); defaults to ``max_len``."""
        cfg = self.cfg
        cross = (cross_len if cross_len is not None else max_len) if cfg.is_encdec else 0
        return {
            "dec": init_stack_cache(
                cfg, n_layers=cfg.n_layers, batch=batch, max_len=max_len,
                device=resolve_device(device), cross_len=cross,
            )
        }

    # ---------------------------------------------------------------- forward
    def encode(self, params, frames: torch.Tensor, remat: bool = False) -> torch.Tensor:
        """Encoder stack over stub frame embeddings [B, S_enc, D]."""
        cfg = self.cfg
        x = frames.to(dtype_of(cfg))
        x, _ = stack_apply(params["enc"], x, cfg, n_layers=cfg.encoder_layers, causal=False,
                           remat=remat)
        return apply_norm(params["enc_norm"], x, cfg)

    def forward(
        self,
        params,
        batch: Dict[str, torch.Tensor],
        *,
        cache: Optional[Dict] = None,
        pos0: int = 0,
        remat: bool = False,
    ) -> Tuple[torch.Tensor, Optional[Dict], torch.Tensor]:
        """Returns (logits [B,S,V] in float32, float64 for a float64 model,
        cache, aux_loss); the cache given is written in place and returned."""
        cfg = self.cfg
        x = embed_apply(params["embed"], batch["tokens"], cfg)

        if cfg.frontend == "vision" and "patch_embeds" in batch:
            pe = batch["patch_embeds"].to(x.dtype)
            x = x.clone()
            x[:, : pe.shape[1]] = pe

        enc_out = None
        if cfg.is_encdec:
            if "enc_out" in batch:
                enc_out = batch["enc_out"]
            elif "frames" in batch:
                enc_out = self.encode(params, batch["frames"], remat=remat)
            # decode steps read cross-K/V from the cache; enc_out may be None

        x, aux = stack_apply(
            params["dec"], x, cfg, n_layers=cfg.n_layers, pos0=pos0,
            cache=None if cache is None else cache["dec"], enc_out=enc_out, causal=True,
            remat=remat,
        )
        x = apply_norm(params["final_norm"], x, cfg)
        return logits_apply(params["embed"], x, cfg), cache, aux


def build_model(cfg: ModelConfig) -> Model:
    defs: Dict[str, Any] = {
        "embed": embed_defs(cfg),
        "final_norm": norm_defs(cfg),
        "dec": stack_defs_for(cfg, n_layers=cfg.n_layers, cross=cfg.is_encdec),
    }
    if cfg.is_encdec:
        enc_cfg = dataclasses.replace(cfg, moe_experts=0, attn_every=0, ssm_state=0, family="dense")
        defs["enc"] = stack_defs_for(enc_cfg, n_layers=cfg.encoder_layers)
        defs["enc_norm"] = norm_defs(cfg)
    return Model(cfg, defs)
