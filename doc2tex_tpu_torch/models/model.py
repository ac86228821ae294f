"""Recognizer assembled from a config dict (counterpart of
``doc2tex_tpu.models.model.Model``).

Every stage combination the JAX module takes:

- FeatureExtraction 'None' + SequenceModeling 'ViT' (hybrid ResNet with or
  without GCB, raw patches, 2d or 1d patching; the fixed sin-cos, the
  truncated or the interpolated learned table) + Prediction 'TFM',
  'Attn' or 'Attnv2';
- FeatureExtraction 'ResNet' / 'VGG' + SequenceModeling 'BiLSTM' / 'None'
  + Prediction 'Attn' / 'Attnv2' / 'TFM'.  With 'None' + 'TFM' the map gets
  the h/w-split 2D sin-cos table and is flattened to H*W positions;
  otherwise its mean over height (one position per column) goes to the
  sequence stage.

As in JAX, a ViT sequence stage behind a feature stage raises
``ValueError``, and so do unknown stage names ('MS_TFM' included: the
converter and the decode runner take that name, the model does not).

``quantize: int8`` in the config (or ``set_quantize``) routes the
encoder's gated products through the int8 op (``ops/quant.py``): the
ResNet's convolutions, the 2d hybrid patch conv and the ViT blocks'
Denses, where the JAX package's ``maybe_conv_general`` and
``maybe_dot_general`` reach; ``int8_full`` also keeps the head's decode
memory in int8, and an explicit parts tuple can add the TFM head's
``decoder_kv``.

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

from ..ops.quant import check_parts
from .bilstm import BiLSTMSeqModeling
from .decoder_lstm import LSTMAttentionDecoder
from .decoder_tfm import TransformerDecoder
from .layers import posenc_2d_hw, quantizable_layers, set_int8
from .resnet import ResNetFeatureExtractor
from .vgg import VGGFeatureExtractor
from .vit import ViTEncoder, grid_size_for


def _vit_from_config(config, dtype) -> ViTEncoder:
    sm = config["SequenceModeling"]["params"]
    backbone = sm.get("backbone") or {}
    backbone_name = backbone.get("name")
    if backbone_name == "cnn":
        backbone_name = None
    patch = tuple(sm.get("patch_size", [2, 2]))
    max_dim = ((config["imgH"], config["max_dimension"][1]) if config.get("imgH")
               else tuple(config["max_dimension"]))
    patching_style = sm.get("patching_style", "2d")
    if patching_style == "1d":
        mode = "interpolate"     # TRIG's learned 1D table
    elif sm.get("fix_embed", False):
        mode = "sincos"
    elif not sm.get("interpolate_embed", True):
        mode = "truncate"
    else:
        mode = "interpolate"
    return ViTEncoder(
        embed_dim=sm["hidden_size"],
        depth=sm["depth"],
        num_heads=sm["num_heads"],
        patch_size=patch,
        max_grid=grid_size_for(max_dim, patch, backbone_name, patching_style),
        backbone_channels=backbone.get("output_channel", 512),
        input_channel=sm.get("input_channel", 1),
        dtype=dtype,
        patching_style=patching_style,
        backbone_name=backbone_name,
        gcb=backbone.get("gcb", False),
        pos_embed_mode=mode,
    )


class Model(nn.Module):
    def __init__(self, config, num_classes: int):
        super().__init__()
        feat, seq, pred = self.stages = (config["FeatureExtraction"]["name"],
                                         config["SequenceModeling"]["name"],
                                         config["Prediction"]["name"])
        if "Vi" in seq and feat != "None":
            raise ValueError("ViT sequence modeling requires Feat='None'")
        self.head = pred
        # like the JAX package: any dtype but 'bfloat16' computes in float32
        self.dtype = (torch.bfloat16 if config.get("dtype", "bfloat16") == "bfloat16"
                      else torch.float32)
        fp = config["FeatureExtraction"].get("params", {}) or {}
        if feat == "ResNet":
            self.featextractor = ResNetFeatureExtractor(
                fp.get("input_channel", 1), fp.get("output_channel", 512), dtype=self.dtype,
                gcb=fp.get("gcb", False))
        elif feat == "VGG":
            self.featextractor = VGGFeatureExtractor(
                fp.get("input_channel", 1), fp.get("output_channel", 512), dtype=self.dtype)
        elif feat == "None":
            self.featextractor = None
        else:
            raise ValueError(f"unknown FeatureExtraction {feat!r}")

        sp = config["SequenceModeling"].get("params", {}) or {}
        if seq == "ViT":
            self.seqmodeler = _vit_from_config(config, self.dtype)
            enc_dim = sp["hidden_size"]
        elif seq == "BiLSTM":
            out = sp.get("output_size", sp.get("hidden_size", 256))
            # the stage's input: the feature map's channels, or the image's
            width = (fp.get("output_channel", 512) if self.featextractor is not None
                     else 3 if config.get("rgb") else 1)
            self.seqmodeler = BiLSTMSeqModeling(
                width, hidden_size=sp.get("hidden_size", 256),
                output_size=out, num_layers=sp.get("num_layers", 2),
                use_pos_enc=sp.get("pos_enc", False))
            enc_dim = out
        elif seq == "None":
            self.seqmodeler = None
            enc_dim = fp.get("output_channel", 512)
        else:
            raise ValueError(f"unknown SequenceModeling {seq!r}")

        pp = dict(config["Prediction"].get("params", {}))
        if pred in ("Attn", "Attnv2"):
            self.predicter = LSTMAttentionDecoder(
                num_classes=num_classes,
                input_size=pp.get("input_size", enc_dim),
                hidden_size=pp.get("hidden_size", 256),
                embed_dim=pp.get("embed_dim"),
                kernel_size=pp.get("kernel_size", 2),
                kernel_dim=pp.get("kernel_dim", 128),
                attn_type=pp.get("attn_type", "coverage"),
                method=pp.get("method", "dot"),
                embed_target=pp.get("embed_target", True),
                enc_init=pp.get("enc_init", False),
                seqmodel=pp.get("seqmodel", "TFM"),
                v2=pred == "Attnv2",
                droprate=pp.get("droprate", 0.1),
                dtype=self.dtype,
            )
        elif pred == "TFM":
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
        else:
            raise ValueError(f"unknown Prediction {pred!r}")

        self.set_quantize(config.get("quantize"))

    def set_quantize(self, mode) -> list[str]:
        """Set the quantized parts from a ``quantize:`` mode (``int8``,
        ``int8_full`` or None) or an explicit tuple of parts (the JAX
        package's ``quantized_inference(parts=...)``; see
        ``ops/quant.check_parts``).  ``encoder``: the encoder's layers that
        JAX's int8 hook reaches go int8 where the shape gates pass;
        ``decoder_mem``/``decoder_kv`` go to the head, which keeps its
        decode memory in int8 (``decoder_kv`` only in the TFM head).
        Returns the names of the layers that take the int8 op."""
        self.quant_parts = check_parts(mode)
        parts = self.quant_parts or ()
        self.predicter.quant_parts = tuple(p for p in parts if p != "encoder")
        self.int8_layers = set_int8(self.int8_modules(), "encoder" in parts)
        return self.int8_layers

    def int8_modules(self) -> list:
        """(name, layer) of the encoder's layers that can take the int8 op:
        the ViT's (``ViTEncoder.int8_modules``) or a ResNet stage's
        convolutions (``resnet.``)."""
        if self.stages[1] == "ViT":
            return list(self.seqmodeler.int8_modules())
        if self.featextractor is None:
            return []
        return list(quantizable_layers(self.featextractor, {"FANResNet_0.": "resnet."}))

    def encode(self, image, train: bool = False, generator=None):
        """image: (B, H, W, C) normalized floats -> encoder memory (B, S, D)."""
        x = image.to(self.dtype)
        if self.stages[1] == "ViT":
            tokens, _grid = self.seqmodeler(x, train, generator)
            return tokens
        x = x.permute(0, 3, 1, 2)
        if self.featextractor is not None:
            x = self.featextractor(x, train)                          # (B, C, H', W')
        if self.stages[1:] == ("None", "TFM"):
            B, C, H, W = x.shape
            x = x.permute(0, 2, 3, 1) + posenc_2d_hw(H, W, C).to(x.device, x.dtype)[None]
            return x.reshape(B, H * W, C)
        x = x.mean(dim=2).transpose(1, 2)                            # (B, W', C)
        return self.seqmodeler(x) if self.seqmodeler is not None else x

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
