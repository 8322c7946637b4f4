"""The caption Transformer: encoder over object slots, decoder over tokens.

Parameter names are the reference's state_dict names
(``core/TRANSFORMER/model.py:44-68,228-412``), including the misspelled
``classifer``, so a reference ``model_N.pt`` loads with ``load_state_dict``.

Reference quirks kept, each behind its config flag (see the JAX package's
``models/captioner.py``):
  * the encoder self-attention adds a causal mask over the object slots when
    ``encode_mask`` (model.py:311-319);
  * ``split_image_objects`` pairs each object with the whole-image feature
    through an extra encoder block (model.py:258-292), and the shared norm
    runs both before the pairing block and after re-assembly
    (model.py:286,309);
  * ``move_first_image_feature`` adds encoder slot 0 to every decoder
    position through a tail FFN (model.py:451-457);
  * the decoder positional table spans ``max_length - 1`` positions
    (model.py:383).

``Captioner.forward`` is the differentiable teacher-forced forward of
training, with dropout at the config's rates when a generator is given;
``Captioner.logits`` is its deterministic, gradient-free form for serving.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..config import ModelConfig
from ..ops import masks as M
from ..ops.attention import dropout
from ..utils.device import DeviceLike, resolve_device
from ..utils.rng import split
from . import layers as L


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" \
        else torch.float32


class Encoder(nn.Module):
    """[B, S, 2048] x [B, S, 84] -> [B, S, D] (model.py:212-359)."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        d = cfg.encode_input_size
        if cfg.split_position:
            # 4 xyxy dims and the class-score tail embedded separately
            # (model.py:231-233,297-303)
            self.position_embedding = L.Linear(4, d, bias=False,
                                               generator=generator)
            self.object_embedding = L.Linear(cfg.dim_positions - 4, d,
                                             bias=False, generator=generator)
        else:
            self.position_embedding = L.Linear(cfg.dim_positions, d,
                                               bias=False, generator=generator)
        self.feature_embedding = L.Linear(cfg.dim_features, d, bias=False,
                                          generator=generator)

        def block():
            return L.EncoderBlock(d, cfg.encode_hidden_size,
                                  cfg.encode_num_heads, cfg.encode_q_k_dim,
                                  cfg.encode_v_dim, generator=generator,
                                  dropout_rate=cfg.dropout,
                                  attention_dropout=cfg.attention_dropout)

        if cfg.split_image_objects:
            self.image_encoder = block()
        self.norm = L.LayerNorm(d)
        self.encoder = nn.ModuleList(
            block() for _ in range(cfg.encode_num_blocks))

    def forward(self, object_features: torch.Tensor,
                position_features: torch.Tensor, *,
                generator: Optional[torch.Generator] = None,
                deterministic: bool = True,
                use_kernel: bool = False, need_weights: bool = False):
        """Returns (output [B, S, D], per-block attention weights or Nones)."""
        cfg = self.cfg
        gens = split(generator, cfg.encode_num_blocks + 1)
        if cfg.split_image_objects:
            b, s, df = object_features.shape
            dp = position_features.shape[-1]
            img_f = object_features[:, :1].expand(b, s, df)
            img_p = position_features[:, :1].expand(b, s, dp)
            # [B*S, 2, .]: token 0 = whole image, token 1 = the object
            # (model.py:262-271)
            feature = torch.stack([img_f, object_features], dim=2).reshape(
                b * s, 2, df)
            position = torch.stack([img_p, position_features], dim=2).reshape(
                b * s, 2, dp)

            non_pad = M.non_pad_mask_from_features(position)
            pair_mask = M.combine_masks(
                M.key_pad_mask_from_features(position, 2),
                M.subsequent_mask(b * s, 2, device=position.device))

            emb_f = self.feature_embedding(feature)
            emb_p = self.position_embedding(position)
            out = self.norm(emb_f + emb_p)
            out, _ = self.image_encoder(
                out, non_pad_mask=non_pad, attention_mask=pair_mask,
                generator=gens[0], deterministic=deterministic,
                use_kernel=use_kernel, need_weights=False)
            d = out.shape[-1]
            output = out[:, 1, :].reshape(b, s, d) + \
                emb_p[:, 1, :].reshape(b, s, d)
        else:
            emb_f = self.feature_embedding(object_features)
            if cfg.split_position:
                output = (emb_f
                          + self.position_embedding(
                              position_features[:, :, :4])
                          + self.object_embedding(
                              position_features[:, :, 4:]))
            else:
                output = emb_f + self.position_embedding(position_features)

        # the shared norm applies in every path (model.py:309)
        output = self.norm(output)

        b, s = position_features.shape[0], position_features.shape[1]
        non_pad = M.non_pad_mask_from_features(position_features)
        # encoder-mask quirk: key-pad OR causal over object slots
        # (model.py:311-319)
        self_mask = M.combine_masks(
            M.key_pad_mask_from_features(position_features, s),
            M.subsequent_mask(b, s, device=position_features.device))

        attentions = []
        for i, block in enumerate(self.encoder):
            masks = (dict(non_pad_mask=non_pad, attention_mask=self_mask)
                     if cfg.encode_mask else {})
            output, attn = block(output, **masks, generator=gens[1 + i],
                                 deterministic=deterministic,
                                 use_kernel=use_kernel,
                                 need_weights=need_weights)
            attentions.append(attn)
        return output, attentions


class Decoder(nn.Module):
    """Full-sequence decoder (model.py:362-486)."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        d = cfg.decode_input_size
        self.word_embedding = nn.Embedding(
            cfg.num_vocab, cfg.dim_word_embedding,
            _weight=L.embedding_table(generator, cfg.num_vocab,
                                      cfg.dim_word_embedding, cfg.pad_idx))
        self.word_embedding_linear = L.Linear(
            cfg.dim_word_embedding, d, bias=False, generator=generator)
        self.norm = L.LayerNorm(d)
        self.decoder = nn.ModuleList(
            L.DecoderBlock(d, cfg.decode_hidden_size, cfg.decode_num_heads,
                           cfg.decode_q_k_dim, cfg.decode_v_dim,
                           generator=generator, dropout_rate=cfg.dropout,
                           attention_dropout=cfg.attention_dropout)
            for _ in range(cfg.decode_num_blocks))
        if cfg.move_first_image_feature:
            self.position_wise_1 = L.Linear(
                d, cfg.decode_hidden_size, bias=True, generator=generator,
                kernel_init=L.normal_fan_sum)
            self.position_wise_2 = L.Linear(
                cfg.decode_hidden_size, d, bias=True, generator=generator,
                kernel_init=L.normal_fan_sum)
            self.layer_norm = L.LayerNorm(d)
        # recomputed, never loaded: the reference's buffer is not needed
        self.register_buffer("pos_table",
                             L.sinusoid_table(cfg.max_length - 1, d),
                             persistent=False)

    def embed(self, caption: torch.Tensor, dtype: torch.dtype,
              position_offset: int = 0) -> torch.Tensor:
        """word embed -> bias-free linear -> +sinusoid -> LayerNorm
        (model.py:432-436)."""
        x = self.word_embedding(caption).to(dtype)
        x = self.word_embedding_linear(x)
        t = caption.shape[-1]
        x = x + self.pos_table[position_offset:position_offset + t].to(
            x.dtype)
        return self.norm(x)

    def move_first_image_feature(self, decode_output: torch.Tensor,
                                 encode_output: torch.Tensor, *,
                                 generator: Optional[torch.Generator] = None,
                                 deterministic: bool = True) -> torch.Tensor:
        """Tail FFN adding encoder slot 0 to every position, with dropout
        (model.py:451-457)."""
        first = encode_output[:, :1]
        h = torch.relu(self.position_wise_1(decode_output + first))
        h = self.position_wise_2(h)
        h = dropout(h, self.cfg.dropout, generator, deterministic)
        return self.layer_norm(h + decode_output)

    def forward(self, caption_vector: torch.Tensor,
                encode_output: torch.Tensor, *,
                context_attention_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                deterministic: bool = True,
                use_kernel: bool = False, need_weights: bool = False):
        """caption_vector [B, T] int -> ([B, T, D], self_attn, cross_attn)
        (model.py:419-459); the weights are the last block's."""
        cfg = self.cfg
        gens = split(generator, cfg.decode_num_blocks + 1)
        b, t = caption_vector.shape
        non_pad = M.non_pad_mask_from_tokens(caption_vector, cfg.pad_idx)
        self_mask = M.combine_masks(
            M.key_pad_mask_from_tokens(caption_vector, t, cfg.pad_idx),
            M.subsequent_mask(b, t, device=caption_vector.device))

        x = self.embed(caption_vector, compute_dtype(cfg))
        self_attn = cross_attn = None
        for i, block in enumerate(self.decoder):
            x, self_attn, cross_attn = block(
                x, encode_output, non_pad_mask=non_pad,
                self_attention_mask=self_mask,
                context_attention_mask=context_attention_mask,
                generator=gens[i], deterministic=deterministic,
                use_kernel=use_kernel, need_weights=need_weights)
        if cfg.move_first_image_feature:
            x = self.move_first_image_feature(
                x, encode_output, generator=gens[-1],
                deterministic=deterministic)
        return x, self_attn, cross_attn


class Captioner(nn.Module):
    """Encoder, decoder and the ``classifer`` Linear(d, vocab).

    Built from a CPU ``torch.Generator`` (seed 0 when none is given) with
    the reference's inits, then moved to ``device``: CUDA when ``device`` is
    None, an error when there is no CUDA."""

    def __init__(self, cfg: ModelConfig, *, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.cfg = cfg
        self.encoder = Encoder(cfg, generator=generator)
        self.decoder = Decoder(cfg, generator=generator)
        # classifier: xavier_normal weight + torch-default bias
        # (model.py:68-69)
        self.classifer = L.Linear(cfg.decode_input_size, cfg.num_vocab,
                                  bias=True, generator=generator,
                                  kernel_init=L.normal_fan_sum)
        self.to(device)

    @property
    def device(self) -> torch.device:
        return self.classifer.weight.device

    def forward(self, object_features, position_features, target_caption,
                *, generator: Optional[torch.Generator] = None,
                deterministic: bool = True,
                use_kernel: bool = False) -> torch.Tensor:
        """Teacher-forced forward: f32 logits over ``target[:, :-1]``
        (model.py:79-93), [B, T-1, V], differentiable.  Dropout runs at the
        config's rates when ``generator`` (on the model's device) is given
        and ``deterministic`` is False; the counterpart of the JAX
        package's ``captioner_logits``."""
        dev = self.device
        object_features = torch.as_tensor(object_features, device=dev)
        position_features = torch.as_tensor(position_features, device=dev)
        input_caption = torch.as_tensor(target_caption,
                                        device=dev)[:, :-1].long()
        context_mask = M.key_pad_mask_from_features(position_features,
                                                    input_caption.shape[1])
        enc_gen, dec_gen = split(generator, 2)
        dtype = compute_dtype(self.cfg)
        encode_output, _ = self.encoder(object_features.to(dtype),
                                        position_features.to(dtype),
                                        generator=enc_gen,
                                        deterministic=deterministic,
                                        use_kernel=use_kernel)
        decode_output, _, _ = self.decoder(
            input_caption, encode_output,
            context_attention_mask=context_mask, generator=dec_gen,
            deterministic=deterministic, use_kernel=use_kernel)
        return self.classifer(decode_output.float())

    @torch.no_grad()
    def logits(self, object_features, position_features, target_caption, *,
               use_kernel: bool = False) -> torch.Tensor:
        """``forward`` without dropout or gradient, for serving."""
        return self.forward(object_features, position_features,
                            target_caption, deterministic=True,
                            use_kernel=use_kernel)


def cross_entropy_ignore_pad(logits: torch.Tensor, targets: torch.Tensor,
                             pad_idx: int = 0) -> torch.Tensor:
    """torch CrossEntropyLoss(ignore_index=pad, reduction='mean'): the sum
    of per-token NLL over non-pad targets over the count of them."""
    v = logits.shape[-1]
    logp = torch.log_softmax(logits.reshape(-1, v), dim=-1)
    tgt = targets.reshape(-1).long()
    nll = -logp.gather(1, tgt[:, None])[:, 0]
    keep = (tgt != pad_idx).to(logp.dtype)
    return (nll * keep).sum() / keep.sum().clamp_min(1.0)


def focal_loss_from_ce(ce_mean: torch.Tensor,
                       gamma: float = 2.0) -> torch.Tensor:
    """The reference's focal loss on the scalar mean CE (loss.py:20-28):
    pt = exp(-CE); (1-pt)^gamma * CE."""
    pt = torch.exp(-ce_mean)
    return (1.0 - pt) ** gamma * ce_mean


def xe_loss(model: Captioner, object_features, position_features,
            target_caption, *, generator: Optional[torch.Generator] = None,
            deterministic: bool = True,
            use_kernel: bool = False) -> Dict[str, torch.Tensor]:
    """XE or focal training loss (model.py:79-98), the counterpart of the
    JAX package's ``captioner_xe_loss``: the mean CE over non-pad targets,
    or the focal loss on that mean when ``cfg.xe_loss == 'focal'``."""
    cfg = model.cfg
    logits = model(object_features, position_features, target_caption,
                   generator=generator, deterministic=deterministic,
                   use_kernel=use_kernel)
    targets = torch.as_tensor(target_caption, device=model.device)[:, 1:]
    ce = cross_entropy_ignore_pad(logits, targets, cfg.pad_idx)
    if cfg.xe_loss == "focal":
        return {"loss": focal_loss_from_ce(ce, cfg.focal_gamma)}
    return {"loss": ce}
