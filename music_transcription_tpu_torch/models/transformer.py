"""AST tier: a mel-patch transformer encoder and a KV-cached token decoder
as torch.nn.Modules (inference, teacher forcing, greedy / sampled / beam /
grammar-constrained generation).

Port of the JAX package's ``models/transformer.py``. Parameters are held
under the names of the flax tree (``dec{i}.self_attn.q``, ``enc{i}.LayerNorm_0``,
``enc{i}.MultiHeadProj_0``, ``enc{i}.Dense_0``, ...), so a flax tree maps
across leaf by leaf (``checkpoints.state_dict_from_jax``) and the encoder
of ``ASTEncoderPretrainer`` transplants into ``ASTTranscriber`` as a
state_dict subset (``patch_embed``, ``enc_pos``, ``enc{i}``, ``enc_norm``).
The forward rounds where flax rounds:

  * a dense layer in ``compute_dtype`` casts input and kernel to it, rounds
    the product to it, then adds the bias in it (a second rounding);
    ``output_fc`` and ``frame_head`` are fp32;
  * embeddings and LayerNorm (eps 1e-6, statistics E[x^2] - E[x]^2) are
    fp32, so both towers' residual streams stay fp32 (fp32 + bf16 -> fp32);
  * attention: fp32 logits times d^-0.5, masked positions set to -1e9, fp32
    softmax, the weights cast to the compute dtype before P.V, which
    accumulates in fp32; the ``o`` projection rounds its input again;
  * GELU is the exact erf form in the compute dtype, as ``jax.nn.gelu``
    computes it: 0.5 * x * erfc(-x * sqrt(0.5)) with sqrt(0.5) rounded to
    the dtype first;
  * the encoder memory is the bf16 output of ``enc_to_dec``; cross-attention
    K and V come from it.

Generation is a Python loop of ``max_len`` steps that keeps tokens, caches,
scores and counts on the device and reads nothing back to the host inside
the loop: every row runs every step, as the JAX package's ``nn.scan`` does.
Constants are written with ``fill_`` (an item assignment of a Python number
copies it from the host and synchronizes).
The self-attention cache of all layers is one (layers, 2, B, heads,
max_len + 1, d) tensor in the compute dtype: it holds the compute-dtype k
and v, which JAX keeps in an fp32 cache, so the values are the same. A step
attends over the cache's written prefix [0, step], where JAX masks the rest
of the cache with -1e9 (weights of exactly 0 there).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from music_transcription_tpu_torch.config import NUM_KEYS, AudioConfig
from music_transcription_tpu_torch.models.cnn_rnn import _dense, _layer_norm
from music_transcription_tpu_torch.ops.dropout import dropout
from music_transcription_tpu_torch.ops.mel import log_mel_batch
from music_transcription_tpu_torch.ops.precision import matmul_f32

NEG = -1e9  # the masked logit of the JAX package (not -inf)
LN_EPS = 1e-6  # flax LayerNorm's epsilon
MAX_PATCHES = 4096  # rows of enc_pos


def _trunc_normal_(t: torch.Tensor, std: float) -> torch.Tensor:
    # flax's truncated normal: cut at 2 std, rescaled to keep the variance
    std = std / 0.87962566103423978
    return nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std)


class Dense(nn.Linear):
    """flax ``nn.Dense(dtype=compute_dtype)``: lecun-normal kernel, zero
    bias; input and kernel cast to ``compute_dtype``, the product rounded to
    it, then the bias added in it."""

    def __init__(self, in_features: int, out_features: int, compute_dtype: torch.dtype):
        super().__init__(in_features, out_features)
        self.compute_dtype = compute_dtype
        _trunc_normal_(self.weight.data, 1.0 / math.sqrt(in_features))
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _dense(x, self, self.compute_dtype)


def _embedding(num: int, dim: int) -> nn.Embedding:
    emb = nn.Embedding(num, dim)
    _trunc_normal_(emb.weight.data, 1.0 / math.sqrt(dim))  # flax's default_embed_init
    return emb


def _drop(mod: nn.Module, x: torch.Tensor, generator) -> torch.Tensor:
    """``mod``'s dropout in training (masks from ``generator``), none in eval."""
    return dropout(x, mod.dropout if mod.training else 0.0, generator)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(x, approximate=False)`` in x's dtype."""
    sqrt_half = torch.tensor(math.sqrt(0.5), dtype=x.dtype)
    return 0.5 * x * torch.erfc(-x * sqrt_half)


def _attention(q, k, v, mask, dtype: torch.dtype, dropout_rate: float = 0.0,
               generator=None) -> torch.Tensor:
    """(B, H, T, D) attention -> (B, T, H * D) fp32; ``mask`` (Tq, Tk) bool,
    True where a key is seen. ``dropout_rate`` > 0 drops the fp32 weights
    (B * H, Tq, Tk) after the softmax, masks from ``generator`` (the
    hFT-Transformer's blocks; the AST tier passes none)."""
    b, h, tq, d = q.shape
    logits = matmul_f32(q.reshape(b * h, tq, d), k.reshape(b * h, -1, d).transpose(1, 2))
    logits = logits * d**-0.5
    if mask is not None:
        logits = logits.masked_fill(~mask, NEG)
    w = torch.softmax(logits, dim=-1)
    if dropout_rate:
        w = dropout(w, dropout_rate, generator)
    out = matmul_f32(w.to(dtype), v.reshape(b * h, -1, d))  # (B*H, Tq, D)
    return out.view(b, h, tq, d).transpose(1, 2).reshape(b, tq, h * d)


class MultiHeadProj(nn.Module):
    def __init__(self, dim: int, heads: int, compute_dtype: torch.dtype):
        super().__init__()
        self.dim, self.heads, self.compute_dtype = dim, heads, compute_dtype
        self.q = Dense(dim, dim, compute_dtype)
        self.k = Dense(dim, dim, compute_dtype)
        self.v = Dense(dim, dim, compute_dtype)
        self.o = Dense(dim, dim, compute_dtype)

    def heads_split(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, dim) -> (B, heads, T, dim // heads), a view."""
        b, t, _ = x.shape
        return x.view(b, t, self.heads, self.dim // self.heads).transpose(1, 2)

    def forward(self, x_q, x_kv, mask=None, dropout_rate: float = 0.0, generator=None):
        q, k, v = (self.heads_split(f(x)) for f, x in ((self.q, x_q), (self.k, x_kv),
                                                         (self.v, x_kv)))
        return self.o(_attention(q, k, v, mask, self.compute_dtype, dropout_rate, generator))

    # --- cached single-step path (generation) ---
    def step(self, x_q1: torch.Tensor, cache: torch.Tensor, pos: int) -> torch.Tensor:
        """x_q1 (B, 1, dim); ``cache`` (2, B, heads, T, d), this step's k and
        v written at ``pos`` in place; attends over [0, pos]."""
        cache[0, :, :, pos] = self.heads_split(self.k(x_q1))[:, :, 0]
        cache[1, :, :, pos] = self.heads_split(self.v(x_q1))[:, :, 0]
        q = self.heads_split(self.q(x_q1))
        out = _attention(q, cache[0, :, :, :pos + 1], cache[1, :, :, :pos + 1], None,
                         self.compute_dtype)
        return self.o(out)

    def cross_kv(self, memory: torch.Tensor):
        """Cross-attention K and V of the memory, (B, heads, S, d) each."""
        return (self.heads_split(self.k(memory)).contiguous(),
                self.heads_split(self.v(memory)).contiguous())

    def cross_step(self, x_q1: torch.Tensor, kv) -> torch.Tensor:
        q = self.heads_split(self.q(x_q1))
        return self.o(_attention(q, kv[0], kv[1], None, self.compute_dtype))


class DecoderLayer(nn.Module):
    """Post-LN decoder layer (torch nn.TransformerDecoderLayer's defaults:
    norm_first=False, exact GELU, FFN 4 x dim)."""

    def __init__(self, dim: int, heads: int, dropout: float, compute_dtype: torch.dtype):
        super().__init__()
        self.dropout = dropout
        self.self_attn = MultiHeadProj(dim, heads, compute_dtype)
        self.cross_attn = MultiHeadProj(dim, heads, compute_dtype)
        self.linear1 = Dense(dim, 4 * dim, compute_dtype)
        self.linear2 = Dense(4 * dim, dim, compute_dtype)
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.norm3 = nn.LayerNorm(dim, eps=LN_EPS)

    def _ffn(self, x, generator=None):
        return self.linear2(_drop(self, _gelu(self.linear1(x)), generator))

    def forward(self, x, memory, causal_mask, generator=None):
        x = _layer_norm(x + _drop(self, self.self_attn(x, x, causal_mask), generator), self.norm1)
        x = _layer_norm(x + _drop(self, self.cross_attn(x, memory), generator), self.norm2)
        return _layer_norm(x + _drop(self, self._ffn(x, generator), generator), self.norm3)

    def step(self, x1, cache, cross_kv, pos: int):
        x1 = _layer_norm(x1 + self.self_attn.step(x1, cache, pos), self.norm1)
        x1 = _layer_norm(x1 + self.cross_attn.cross_step(x1, cross_kv), self.norm2)
        return _layer_norm(x1 + self._ffn(x1), self.norm3)


class EncoderLayer(nn.Module):
    """Pre-LN encoder block. Its submodules carry the names flax's compact
    ``EncoderLayer`` gives them."""

    def __init__(self, dim: int, heads: int, dropout: float, compute_dtype: torch.dtype):
        super().__init__()
        self.dropout = dropout
        self.LayerNorm_0 = nn.LayerNorm(dim, eps=LN_EPS)
        self.MultiHeadProj_0 = MultiHeadProj(dim, heads, compute_dtype)
        self.LayerNorm_1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.Dense_0 = Dense(dim, 4 * dim, compute_dtype)
        self.Dense_1 = Dense(4 * dim, dim, compute_dtype)

    def forward(self, x, generator=None):
        h = _layer_norm(x, self.LayerNorm_0)
        x = x + _drop(self, self.MultiHeadProj_0(h, h), generator)
        h = self.Dense_1(_gelu(self.Dense_0(_layer_norm(x, self.LayerNorm_1))))
        return x + _drop(self, h, generator)


ENCODER_PARAM_KEYS = ("patch_embed", "enc_pos", "enc_norm")  # + the enc{i} blocks


def encoder_subtree(key: str) -> str | None:
    """The encoder subtree a state_dict key belongs to (``patch_embed``,
    ``enc_pos``, ``enc{i}``, ``enc_norm``), or None: ``enc_to_dec``, the
    decoder and ``frame_head`` are not the encoder's."""
    head = key.split(".", 1)[0]
    if head in ENCODER_PARAM_KEYS or (head.startswith("enc") and head[3:].isdigit()):
        return head
    return None


def encoder_state_dict(state: dict) -> dict:
    """The encoder's entries of an ``ASTTranscriber``'s or
    ``ASTEncoderPretrainer``'s state_dict: the unit a pretrained encoder
    transplants as (the JAX package's ``encoder_param_subtrees``)."""
    return {k: v for k, v in state.items() if encoder_subtree(k) is not None}


class MelPatchEncoder(nn.Module):
    """The mel-patch encoder's parameters and body, under the same names in
    ASTTranscriber and ASTEncoderPretrainer (``patch_embed``, ``enc_pos``,
    ``enc{i}``, ``enc_norm``), so a pretrained encoder transplants as a
    state_dict subset (``encoder_state_dict``)."""

    encoder_layers = 0  # no encoder (the transcriber's mock path)

    def _init_encoder(self, layers: int, dim: int, heads: int, n_mels: int, patch_frames: int,
                      dropout_rate: float, dt: torch.dtype) -> None:
        self.n_mels, self.patch_frames, self.encoder_layers = n_mels, patch_frames, layers
        self.patch_embed = Dense(n_mels * patch_frames, dim, dt)
        self.enc_pos = _embedding(MAX_PATCHES, dim)
        for i in range(layers):
            self.add_module(f"enc{i}", EncoderLayer(dim, heads, dropout_rate, dt))
        self.enc_norm = nn.LayerNorm(dim, eps=LN_EPS)

    @property
    def enc_blocks(self) -> list:
        return [getattr(self, f"enc{i}") for i in range(self.encoder_layers)]

    def encode_mel_patches(self, waveforms: torch.Tensor, generator=None) -> torch.Tensor:
        """(B, L) audio -> (B, S, encoder_dim) fp32: log-mel at the default
        audio fields with ``n_mels`` bins, patches of ``patch_frames`` frames
        flattened mel-major (index m * patch_frames + f), patch embed, learned
        positions, pre-LN blocks, final LN."""
        mel = log_mel_batch(waveforms, AudioConfig(n_mels=self.n_mels))  # (B, M, T)
        b, m, t = mel.shape
        pf = self.patch_frames
        t_trim = (t // pf) * pf
        patches = mel[:, :, :t_trim].reshape(b, m, -1, pf).permute(0, 2, 1, 3)
        x = self.patch_embed(patches.reshape(b, t_trim // pf, m * pf))
        x = x + self.enc_pos.weight[:x.shape[1]][None]
        for blk in self.enc_blocks:
            x = blk(x, generator)
        return _layer_norm(x, self.enc_norm)


class ASTEncoderPretrainer(MelPatchEncoder):
    """Frame-supervised pretraining tower for the mel-patch encoder: frame
    logits (B, 88, S * patch_frames), ``patch_frames`` frames per encoder
    token from an fp32 ``frame_head``."""

    def __init__(self, encoder_layers: int = 4, encoder_dim: int = 384, encoder_heads: int = 6,
                 patch_frames: int = 4, n_mels: int = 128, dropout: float = 0.1,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self._init_encoder(encoder_layers, encoder_dim, encoder_heads, n_mels, patch_frames,
                           dropout, compute_dtype)
        self.frame_head = Dense(encoder_dim, patch_frames * NUM_KEYS, torch.float32)

    def forward(self, waveforms: torch.Tensor, generator=None) -> torch.Tensor:
        h = self.frame_head(self.encode_mel_patches(waveforms, generator))  # (B, S, pf * 88)
        b, s, _ = h.shape
        return h.reshape(b, s * self.patch_frames, NUM_KEYS).transpose(1, 2)


def _stable_top_k(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` along the last axis: descending, ties to the lower
    index (a stable sort; ``torch.topk`` promises no order among ties)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def _categorical(logits: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One sample per row, by the Gumbel-max rule of ``jax.random.categorical``
    (other bits: the generators differ)."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp_(min=torch.finfo(u.dtype).tiny)))
    return (logits + gumbel).argmax(dim=-1)


class ASTTranscriber(MelPatchEncoder):
    """waveforms (B, L) -> token logits (B, T, V) with ``targets`` (teacher
    forcing), else generated ids (B, generate_max_len)."""

    def __init__(self, remi_vocab_size: int = 512, decoder_layers: int = 4,
                 decoder_dim: int = 384, decoder_heads: int = 6, dropout: float = 0.2,
                 max_output_len: int = 1024, encoder_layers: int = 4, encoder_dim: int = 384,
                 encoder_heads: int = 6, patch_frames: int = 4, n_mels: int = 128,
                 use_mock_encoder: bool = False, freeze_encoder: bool = True,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.vocab_size, self.decoder_layers = remi_vocab_size, decoder_layers
        self.decoder_dim, self.decoder_heads = decoder_dim, decoder_heads
        self.use_mock_encoder, self.freeze_encoder = use_mock_encoder, freeze_encoder
        self.compute_dtype = compute_dtype
        self.enc_to_dec = Dense(decoder_dim if use_mock_encoder else encoder_dim, decoder_dim,
                                compute_dtype)
        self.token_emb = _embedding(remi_vocab_size, decoder_dim)
        self.pos_emb = _embedding(max_output_len, decoder_dim)
        for i in range(decoder_layers):
            self.add_module(f"dec{i}", DecoderLayer(decoder_dim, decoder_heads, dropout,
                                                    compute_dtype))
        self.output_fc = Dense(decoder_dim, remi_vocab_size, torch.float32)
        if not use_mock_encoder:
            self._init_encoder(encoder_layers, encoder_dim, encoder_heads, n_mels, patch_frames,
                               0.1, compute_dtype)

    @property
    def layers(self) -> list:
        return [getattr(self, f"dec{i}") for i in range(self.decoder_layers)]

    # ------------------------------------------------------------- encoding
    def _encode(self, waveforms, generator=None):
        if self.use_mock_encoder:
            # shaped pseudo-random features, S = L // 160: the JAX package
            # draws them from jax.random.key(0), the port from a
            # torch.Generator seeded 0 (same shapes and law, other values)
            b, n = waveforms.shape
            g = torch.Generator(device=waveforms.device)
            g.manual_seed(0)
            return torch.randn((b, max(1, n // 160), self.decoder_dim), generator=g,
                               device=waveforms.device)
        return self.encode_mel_patches(waveforms, generator)

    def memory(self, waveforms: torch.Tensor, generator=None) -> torch.Tensor:
        """(B, L) audio -> the decoder's (B, S, decoder_dim) memory in the
        compute dtype; ``freeze_encoder`` stops the gradient at the encoder."""
        feats = self._encode(waveforms, generator)
        if self.freeze_encoder:
            feats = feats.detach()
        return self.enc_to_dec(feats)

    # ------------------------------------------------------ teacher forcing
    def forward(self, waveforms: torch.Tensor, targets: torch.Tensor | None = None,
                generate_max_len: int = 256, generator: torch.Generator | None = None,
                **gen_kwargs):
        """``generator`` draws a training forward's dropout masks, or the
        samples of generation with ``do_sample``."""
        memory = self.memory(waveforms, generator if self.training else None)
        if targets is None:
            beam_size = gen_kwargs.pop("beam_size", 1)
            if beam_size > 1:
                return self.generate_beam(memory, beam_size=beam_size,
                                          max_len=generate_max_len, **gen_kwargs)
            gen_kwargs.pop("length_penalty", None)
            return self.generate(memory, max_len=generate_max_len, generator=generator,
                                 **gen_kwargs)
        t = targets.shape[1]
        x = self.token_emb(targets) + self.pos_emb.weight[:t][None]
        causal = torch.ones((t, t), dtype=torch.bool, device=targets.device).tril()
        for layer in self.layers:
            x = layer(x, memory, causal, generator)
        return self.output_fc(x)  # (B, T, V) fp32

    # ------------------------------------------------------------ generation
    def _start(self, memory: torch.Tensor, max_len: int):
        """Empty self-attention caches (layers, 2, B, heads, max_len + 1, d)
        and each layer's cross-attention K and V."""
        if max_len > self.pos_emb.num_embeddings:
            raise ValueError(f"max_len {max_len} exceeds the decoder's "
                             f"{self.pos_emb.num_embeddings} positions (max_output_len)")
        b, _, dim = memory.shape
        caches = torch.empty((self.decoder_layers, 2, b, self.decoder_heads, max_len + 1,
                              dim // self.decoder_heads), dtype=self.compute_dtype,
                             device=memory.device)
        return caches, [layer.cross_attn.cross_kv(memory) for layer in self.layers]

    def _decode_step(self, tok, caches, cross_kvs, step: int, mask_sos: bool, sos_id: int,
                     banned) -> torch.Tensor:
        """One KV-cached decoder step shared by greedy/sampled and beam
        decoding: embed the previous token, run the layers (each writes its
        cache at ``step``), project to (B, V) logits, then the SOS mask and
        the grammar mask (``banned``: the complement of ``allowed_next``)."""
        x1 = (self.token_emb(tok) + self.pos_emb.weight[step])[:, None]
        for layer, cache, ckv in zip(self.layers, caches, cross_kvs):
            x1 = layer.step(x1, cache, ckv, step)
        logits = self.output_fc(x1)[:, 0]
        if mask_sos and step > 0:
            logits[:, sos_id].fill_(NEG)
        if banned is not None:
            # the row of the previously emitted token vetoes illegal successors
            logits = logits.masked_fill(banned[tok], NEG)
        return logits

    @staticmethod
    def _banned(allowed_next, device):
        if allowed_next is None:
            return None
        return ~torch.as_tensor(allowed_next, device=device).to(torch.bool)

    @torch.no_grad()
    def generate(self, memory: torch.Tensor, sos_id: int = 0, max_len: int = 256,
                 do_sample: bool = False, temperature: float = 1.0, top_k: int = 0,
                 mask_sos: bool = True, repetition_penalty: float = 0.0, allowed_next=None,
                 generator: torch.Generator | None = None) -> torch.Tensor:
        """KV-cached autoregressive decode -> (B, max_len) ids: greedy, or
        sampled (temperature, top-k) from ``generator`` (default: a
        generator seeded 0 on the memory's device, so repeated calls agree);
        the SOS id masked after step 0; a count-based repetition penalty;
        ``allowed_next`` a (V, V) bool successor table (the tokenizer's
        ``transition_mask()``) whose row for the previous token masks the
        logits: grammar-constrained decoding."""
        b, dev = memory.shape[0], memory.device
        if do_sample and generator is None:
            generator = torch.Generator(device=dev)
            generator.manual_seed(0)
        caches, cross_kvs = self._start(memory, max_len)
        banned = self._banned(allowed_next, dev)
        penalize = bool(repetition_penalty) and repetition_penalty > 0.0
        if penalize:
            counts = torch.zeros((b, self.vocab_size), dtype=torch.float32, device=dev)
            counts[:, sos_id].fill_(1.0)
            ones = torch.ones((b, 1), dtype=torch.float32, device=dev)
        tok = torch.full((b,), sos_id, dtype=torch.long, device=dev)
        out = torch.empty((b, max_len), dtype=torch.long, device=dev)
        for step in range(max_len):
            logits = self._decode_step(tok, caches, cross_kvs, step, mask_sos, sos_id, banned)
            if penalize:
                logits = logits - repetition_penalty * counts
            if do_sample:
                logits = logits / max(1e-8, temperature)
                if top_k and top_k > 0:
                    kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
                    logits = logits.masked_fill(logits < kth, NEG)
                tok = _categorical(logits, generator)
            else:
                tok = logits.argmax(dim=-1)
            if penalize:
                counts.scatter_add_(1, tok[:, None], ones)
            out[:, step] = tok
        return out

    @torch.no_grad()
    def generate_beam(self, memory: torch.Tensor, beam_size: int = 4, sos_id: int = 0,
                      eos_id: int = 1, pad_id: int = 2, max_len: int = 256,
                      length_penalty: float = 0.6, mask_sos: bool = True,
                      allowed_next=None) -> torch.Tensor:
        """Beam search -> (B, max_len) ids of each row's best hypothesis.

        The beam rides the batch: all B * beam hypotheses step as one cached
        decoder call, and the caches, token buffer, ``finished`` and
        ``lengths`` are reindexed by each step's parents (one gather each).
        Finished beams emit <pad> at score 0. Hypotheses rank by
        score / length ** length_penalty (GNMT), unfinished ones at length
        ``max_len``. Composes with ``allowed_next``."""
        b, dev, v = memory.shape[0], memory.device, self.vocab_size
        caches, cross_kvs = self._start(memory.repeat_interleave(beam_size, dim=0), max_len)
        banned = self._banned(allowed_next, dev)
        # all beams start identical: only beam 0 is live, so the first top-k
        # fans out to distinct tokens instead of beam_size copies
        scores = torch.full((b, beam_size), NEG, dtype=torch.float32, device=dev)
        scores[:, 0].fill_(0.0)
        finished = torch.zeros((b, beam_size), dtype=torch.bool, device=dev)
        lengths = torch.full((b, beam_size), max_len, dtype=torch.long, device=dev)
        tokbuf = torch.full((b, beam_size, max_len), pad_id, dtype=torch.long, device=dev)
        pad_row = torch.full((v,), NEG, dtype=torch.float32, device=dev)
        pad_row[pad_id:pad_id + 1].fill_(0.0)
        rows = torch.arange(b, device=dev)[:, None]
        tok = torch.full((b * beam_size,), sos_id, dtype=torch.long, device=dev)
        for step in range(max_len):
            logits = self._decode_step(tok, caches, cross_kvs, step, mask_sos, sos_id, banned)
            logp = torch.log_softmax(logits.float(), dim=-1).view(b, beam_size, v)
            logp = torch.where(finished[:, :, None], pad_row, logp)
            cand = scores[:, :, None] + logp
            scores, idx = _stable_top_k(cand.view(b, beam_size * v), beam_size)
            parent, tok_new = idx // v, idx % v
            caches = caches.index_select(2, (rows * beam_size + parent).view(-1))
            tokbuf = tokbuf[rows, parent]
            tokbuf[:, :, step] = tok_new
            was_finished = finished[rows, parent]
            is_eos = tok_new == eos_id
            lengths = torch.where(is_eos & ~was_finished, step + 1, lengths[rows, parent])
            finished = was_finished | is_eos
            tok = tok_new.view(-1)
        norm = scores / lengths.float().pow(length_penalty)
        return tokbuf[rows[:, 0], norm.argmax(dim=1)]
