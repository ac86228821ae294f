"""Recognizer assembled from a config dict (counterpart of
``doc2tex_tpu.models.model.Model``, the ViT branch).

Ported stage combinations: FeatureExtraction 'None' + SequenceModeling 'ViT'
(resnet hybrid, 2d patches, fixed sin-cos table) + Prediction 'TFM', or
'Attn'/'Attnv2' (the coverage-LSTM head).  Any other combination raises
``NotImplementedError``.

``quantize: int8`` in the config (or ``set_quantize``) routes the
encoder's gated products through the int8 op (``ops/quant.py``).

Interface, as the JAX module's:
- ``forward(image, text, train, generator)``: teacher-forced logits
  (training and the validation loss; both heads).  ``train`` is an
  argument, as in JAX, not ``nn.Module.training``: decoding never runs with
  batch statistics or dropout, whatever mode the module was left in;
- ``encode(image)``: normalized (B, H, W, C) floats -> memory (B, S, D)
- ``init_decode_state(enc, max_steps, beam_size, live_steps)``
- ``decode_step(state, tokens) -> (state, logits)``
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..ops.quant import parts_for_mode
from .decoder_lstm import LSTMAttentionDecoder
from .decoder_tfm import TransformerDecoder
from .vit import ViTEncoder, grid_size_for


def _vit_from_config(config, dtype) -> ViTEncoder:
    sm = config["SequenceModeling"]["params"]
    backbone = sm.get("backbone") or {}
    if backbone.get("name") != "resnet" or backbone.get("gcb", False):
        raise NotImplementedError(f"ViT backbone {backbone!r} is not ported yet")
    if sm.get("patching_style", "2d") != "2d" or not sm.get("fix_embed", False):
        raise NotImplementedError("only the 2d-patch, fixed sin-cos ViT is ported")
    patch = tuple(sm.get("patch_size", [2, 2]))
    max_dim = ((config["imgH"], config["max_dimension"][1]) if config.get("imgH")
               else tuple(config["max_dimension"]))
    return ViTEncoder(
        embed_dim=sm["hidden_size"],
        depth=sm["depth"],
        num_heads=sm["num_heads"],
        patch_size=patch,
        max_grid=grid_size_for(max_dim, patch, "resnet"),
        backbone_channels=backbone.get("output_channel", 512),
        input_channel=sm.get("input_channel", 1),
        dtype=dtype,
    )


class Model(nn.Module):
    def __init__(self, config, num_classes: int):
        super().__init__()
        stages = (config["FeatureExtraction"]["name"],
                  config["SequenceModeling"]["name"],
                  config["Prediction"]["name"])
        if stages[:2] != ("None", "ViT") or stages[2] not in ("TFM", "Attn", "Attnv2"):
            raise NotImplementedError(f"stage combination {stages} is not ported yet")
        self.head = stages[2]
        # like the JAX package: any dtype but 'bfloat16' computes in float32
        self.dtype = (torch.bfloat16 if config.get("dtype", "bfloat16") == "bfloat16"
                      else torch.float32)
        self.seqmodeler = _vit_from_config(config, self.dtype)
        enc_dim = config["SequenceModeling"]["params"]["hidden_size"]
        pp = dict(config["Prediction"].get("params", {}))
        if self.head != "TFM":
            self.predicter = LSTMAttentionDecoder(
                num_classes=num_classes,
                input_size=pp.get("input_size", enc_dim),
                hidden_size=pp.get("hidden_size", 256),
                embed_dim=pp.get("embed_dim"),
                kernel_size=pp.get("kernel_size", 2),
                kernel_dim=pp.get("kernel_dim", 128),
                attn_type=pp.get("attn_type", "coverage"),
                embed_target=pp.get("embed_target", True),
                enc_init=pp.get("enc_init", False),
                seqmodel=pp.get("seqmodel", "TFM"),
                v2=self.head == "Attnv2",
                droprate=pp.get("droprate", 0.1),
                dtype=self.dtype,
            )
        else:
            self.predicter = TransformerDecoder(
                num_classes=num_classes,
                d_model=pp.get("d_model", enc_dim),
                nhead=pp.get("nhead", 8),
                num_decoder_layers=pp.get("num_decoder_layers", 3),
                dim_feedforward=pp.get("dim_feedforward", 1024),
                max_seq_len=config.get("batch_max_length", 150) + 2,
                padding_idx=0,
                dtype=self.dtype,
                dropout=pp.get("dropout", 0.3),
            )

        self.set_quantize(config.get("quantize"))

    def set_quantize(self, mode) -> list[str]:
        """Set the quantized parts from a ``quantize:`` mode (``int8`` or
        None; see ``ops/quant.parts_for_mode``).  Only the encoder goes
        int8: its convolutions and the ViT blocks' Denses, where the shape
        gates pass.  Returns the names of the layers that take the int8
        op."""
        self.quant_parts = parts_for_mode(mode)
        self.int8_layers = self.seqmodeler.set_int8(self.quant_parts is not None)
        return self.int8_layers

    def encode(self, image, train: bool = False, generator=None):
        """image: (B, H, W, C) normalized floats -> encoder memory (B, S, D)."""
        tokens, _grid = self.seqmodeler(image.to(self.dtype), train, generator)
        return tokens

    def forward(self, image, text, train: bool = False, generator=None):
        """Teacher-forced logits (B, T, V) float32; ``text`` is the encoded
        labels without their last column.  With ``train`` the BatchNorm
        layers use (and fold in) the batch statistics and dropout draws
        from ``generator``."""
        return self.predicter(self.encode(image, train, generator), text, train, generator)

    def init_decode_state(self, enc, max_steps: int, beam_size: int = 1,
                          live_steps: int | None = None):
        """The TFM head sizes its caches by ``max_steps`` (``live_steps``
        at first); the LSTM head's state does not depend on them."""
        if self.head == "TFM":
            return self.predicter.init_state(enc, max_steps, beam_size, live_steps=live_steps)
        return self.predicter.init_state(enc, beam_size)

    def decode_step(self, state, tokens):
        return self.predicter.step(state, tokens)


def build_model(config, num_classes: int) -> Model:
    return Model(config, num_classes)
