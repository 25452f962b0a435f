"""xLSTM language model: periods of (slstm_period - 1) mLSTM layers
followed by one sLSTM layer (arXiv:2405.04517).

Port of ``repro/models/xlstm_model.py``.  Parameters keep the reference's
names and layout: the mLSTM weights stacked on leading (num_periods,
mlstm_per_period) axes, the sLSTM weights on a leading num_periods axis
(always allocated, applied only when the config has sLSTM layers), so
``convert.xlstm_params_from_numpy`` carries ``repro``'s params across
unchanged.  The two ``lax.scan``s (periods, mLSTM layers within a period)
become Python loops.  ``forward`` is the full-sequence scoring and
training pass, every layer from the zero state (through the
``mlstm_scan`` op when ``cfg.use_pallas_kernels``, which only inference
may set); ``prefill`` and ``decode_step`` take the plain chunked scan and
the decode recurrences, as the reference routes them.  When autograd
records, ``cfg.remat`` recomputes each period (its mLSTM layers and the
sLSTM layer) in the backward pass.
The cache is recurrent state only: nothing in it grows with the sequence.

On a (data, model) grid of ranks (``sharding/parallel.use_grid``) the
same methods run one rank's share on its shard of the parameters: the
embedding and head vocab-parallel (``transformer.embed_tokens``,
``head_logits``), each mLSTM and sLSTM layer over this rank's heads
(``blocks.apply_mlstm_layer``, ``apply_slstm_layer``); the cache holds
this rank's heads' states.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch._device import resolve_device
from repro_torch.models import blocks
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import embed_tokens, head_logits, layer_views, remat
from repro_torch.nn import xlstm as xlstm_lib
from repro_torch.nn.layers import dense_init, embed_init

Params = dict[str, Any]


class XLSTMCache(NamedTuple):
    mlstm: xlstm_lib.MLSTMState   # leading dims (P, mlstm_per_period)
    slstm: xlstm_lib.SLSTMState   # leading dim (P,)


class XLSTMModel:
    def __init__(self, cfg: ModelConfig):
        period = cfg.slstm_period or 1
        if cfg.family != "ssm" or cfg.num_layers % period:
            raise ValueError(
                f"XLSTMModel needs family 'ssm' and num_layers a multiple of slstm_period, "
                f"got {cfg.family!r}, {cfg.num_layers} and {cfg.slstm_period}"
            )
        self.cfg = cfg
        self.num_periods = cfg.num_layers // period
        self.has_slstm = cfg.slstm_period > 1
        self.mlstm_per_period = period - 1 if self.has_slstm else 1

    # ------------------------------------------------------------- params
    def init(self, gen: torch.Generator) -> Params:
        """Seeded random parameters on the generator's device."""
        cfg = self.cfg
        v, d = cfg.padded_vocab, cfg.d_model
        return {
            "embed": embed_init(gen, v, d, cfg.torch_dtype),
            "mlstm": blocks.init_mlstm_layer(
                gen, cfg, stack=(self.num_periods, self.mlstm_per_period)),
            "slstm": blocks.init_slstm_layer(gen, cfg, stack=(self.num_periods,)),
            "ln_f": torch.ones((d,), dtype=cfg.torch_dtype, device=gen.device),
            "head": dense_init(gen, (d, v), cfg.torch_dtype),
        }

    def mlstm_layers(self, params: Params) -> list[list[Params]]:
        """Views of the mLSTM layers, indexed [period][layer]."""
        return [layer_views(p, self.mlstm_per_period)
                for p in layer_views(params["mlstm"], self.num_periods)]

    def _logits(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        return head_logits(params, x, self.cfg)

    def _local(self) -> tuple[int, int]:
        """(mLSTM heads, sLSTM channels) of this rank: the heads of its
        block of ``wq``'s columns and a quarter of its block of ``wx``'s
        (four gates), as the spec tree cuts them."""
        cfg = self.cfg
        heads = blocks.local_units(cfg, cfg.num_heads, blocks.local_block(cfg, "mlstm", "wq"),
                                   cfg.num_heads * cfg.hd)
        return heads, blocks.local_block(cfg, "slstm", "wx") // 4

    def _zero(self, batch: int, device) -> tuple:
        """The zero mLSTM and sLSTM states of one layer, this rank's
        heads and channels."""
        cfg = self.cfg
        heads, d = self._local()
        return (xlstm_lib.init_mlstm_state(batch, heads, cfg.hd, cfg.hd, device=device),
                xlstm_lib.init_slstm_state(batch, d, device=device))

    # ------------------------------------------------------------ forward
    def forward(self, params: Params, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
        """Full-sequence forward.  Returns (logits, 0): no MoE term."""
        cfg = self.cfg
        x = embed_tokens(params, batch["tokens"], cfg)

        def period_body(x, mlstm, slstm):
            for mp in mlstm:
                x, _ = blocks.apply_mlstm_layer(mp, x, cfg, None)
            if self.has_slstm:
                x, _ = blocks.apply_slstm_layer(slstm, x, cfg, None)
            return x

        run = remat(period_body, cfg)
        for mlstm, slstm in zip(self.mlstm_layers(params),
                                layer_views(params["slstm"], self.num_periods)):
            x = run(x, mlstm, slstm)
        return self._logits(params, x), torch.zeros((), dtype=torch.float32, device=x.device)

    # ------------------------------------------------------------ prefill
    def init_cache(self, batch_size: int, max_len: int, device=None) -> XLSTMCache:
        """The zero state of every layer (m at -1e30); ``max_len`` is
        ignored, as a recurrent state has no per-position slots.  On a
        grid of this rank's heads and channels, B its data row's."""
        del max_len
        pm = (self.num_periods, self.mlstm_per_period)
        m_one, s_one = self._zero(batch_size, resolve_device(device))
        return XLSTMCache(
            mlstm=xlstm_lib.MLSTMState(*(t.expand(pm + t.shape).clone() for t in m_one)),
            slstm=xlstm_lib.SLSTMState(
                *(t.expand((self.num_periods,) + t.shape).clone() for t in s_one)),
        )

    def prefill(self, params: Params, batch: dict, max_len: int | None = None):
        """The stateful full-sequence pass: every layer runs from the zero
        state and its final state is collected into the decode cache
        (``max_len`` is ignored: a recurrent state has no per-position
        cache to size).  Returns (logits of the last position, cache)."""
        del max_len
        cfg = self.cfg
        x = embed_tokens(params, batch["tokens"], cfg)
        m_zero, s_zero = self._zero(x.shape[0], x.device)
        mlstm = self.mlstm_layers(params)
        slstm = layer_views(params["slstm"], self.num_periods)
        m_states, s_states = [], []
        for i in range(self.num_periods):
            for j in range(self.mlstm_per_period):
                x, st = blocks.apply_mlstm_layer(mlstm[i][j], x, cfg, m_zero)
                m_states.append(st)
            if self.has_slstm:
                x, st = blocks.apply_slstm_layer(slstm[i], x, cfg,
                                                 s_zero)
            else:
                st = s_zero
            s_states.append(st)
        pm = (self.num_periods, self.mlstm_per_period)
        mlstm = xlstm_lib.MLSTMState(
            *(torch.stack(ts).reshape(pm + ts[0].shape) for ts in zip(*m_states)))
        slstm = xlstm_lib.SLSTMState(*(torch.stack(ts) for ts in zip(*s_states)))
        return self._logits(params, x[:, -1:]), XLSTMCache(mlstm=mlstm, slstm=slstm)

    # ------------------------------------------------------------- decode
    def decode_step(self, params: Params, batch: dict, cache: XLSTMCache):
        """One-token step.  batch['tokens']: (B, 1).  Writes every layer's
        new state into ``cache`` in place and returns (logits, cache)."""
        cfg = self.cfg
        x = embed_tokens(params, batch["tokens"], cfg)
        mlstm = self.mlstm_layers(params)
        slstm = layer_views(params["slstm"], self.num_periods)
        for i in range(self.num_periods):
            for j in range(self.mlstm_per_period):
                st = xlstm_lib.MLSTMState(*(t[i, j] for t in cache.mlstm))
                x, st = blocks.apply_mlstm_layer(mlstm[i][j], x, cfg, st)
                for dst, src in zip(cache.mlstm, st):
                    dst[i, j].copy_(src)
            if self.has_slstm:
                st = xlstm_lib.SLSTMState(*(t[i] for t in cache.slstm))
                x, st = blocks.apply_slstm_layer(slstm[i], x, cfg, st)
                for dst, src in zip(cache.slstm, st):
                    dst[i].copy_(src)
        return self._logits(params, x), cache
