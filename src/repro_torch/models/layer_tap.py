"""Layer taps: the input and output of each layer of a hybrid or xLSTM
model's ``forward`` or ``prefill``, and a replay of recorded inputs
through the layers of another run.

A grid of ranks and one device round differently; in these recurrent
models the layers after a layer amplify its rounding, so the logits of
the two runs part by far more than any one layer does.  Recording each
layer's input and output on the grid, then feeding the same inputs to the
one-device layers (``LayerTap(replay=...)``), holds every layer against
its one-device self on the same input, before any amplification::

    with LayerTap() as grid_tap:            # on each rank
        model.prefill(shard, prompt)
    calls = gather_calls([(coords, grid_tap.calls), ...])
    with LayerTap(replay=calls) as one:     # one device, whole params
        model.prefill(params, whole_prompt)
    # one.calls[i][2] is the one-device layer i on calls[i][1]

The taps record only inside ``HybridModel``/``XLSTMModel.forward`` and
``prefill`` (a decode step's input also depends on its cache, which a
replay does not carry): each Mamba2, mLSTM and sLSTM layer, Zamba2's
shared block (``apply_transformer_layer`` in the forward; its attention
and FFN in the prefill) and the head.  A call nested in another (the
shared block's FFN) has its own entry, after its caller's.
"""
from __future__ import annotations

import torch

_TAPPED = ("apply_mamba_layer", "apply_mlstm_layer", "apply_slstm_layer",
           "apply_transformer_layer", "apply_ffn")


class LayerTap:
    """Inside ``with``, ``calls`` gets (name, input, output) of every
    tapped call on the host (output: the call's first result), in call
    order.  With ``replay`` (a list of such entries from another run, in
    the same order) each call takes the recorded input in place of its
    own."""

    def __init__(self, replay: list | None = None):
        self.replay, self.calls, self._on, self._saved = replay, [], False, []

    def _wrap(self, name, fn):
        def call(p, x, *args, **kw):
            if not self._on:
                return fn(p, x, *args, **kw)
            i = len(self.calls)
            self.calls.append(None)          # this call's slot, before any nested one's
            if self.replay is not None:
                x = self.replay[i][1].to(device=x.device)
            out = fn(p, x, *args, **kw)
            y = out[0] if isinstance(out, tuple) else out
            self.calls[i] = (name, x.detach().cpu(), y.detach().cpu())
            return out

        return call

    def _scope(self, method):
        def call(model, *args, **kw):
            self._on = True
            try:
                return method(model, *args, **kw)
            finally:
                self._on = False

        return call

    def __enter__(self):
        from repro_torch.models import blocks, hybrid_model, xlstm_model

        targets = ([(blocks, n) for n in _TAPPED]
                   + [(hybrid_model, "_attention_collect_kv"), (hybrid_model, "head_logits"),
                      (xlstm_model, "head_logits")])
        for mod, name in targets:
            fn = getattr(mod, name)
            self._saved.append((mod, name, fn))
            setattr(mod, name, self._wrap(name, fn))
        for cls in (hybrid_model.HybridModel, xlstm_model.XLSTMModel):
            for name in ("forward", "prefill"):
                method = getattr(cls, name)
                self._saved.append((cls, name, method))
                setattr(cls, name, self._scope(method))
        return self

    def __exit__(self, *exc):
        for owner, name, fn in reversed(self._saved):
            setattr(owner, name, fn)
        self._saved = []
        return False


def gather_calls(ranks: list) -> tuple[list, bool]:
    """The whole batch's entries from every rank's ``(coords, calls)`` of
    one run on a (data, model) grid: inputs and outputs joined over the
    data rows, the head's vocab-split output also over the model row.
    Returns them and whether every other output agreed bit for bit across
    each model row (every rank of a row holds the same activations)."""
    by = {(c["data"], c["model"]): calls for c, calls in ranks}
    rows = sorted({d for d, _ in by})
    cols = sorted({m for _, m in by})
    out, same = [], True
    for i, (name, _, _) in enumerate(by[(rows[0], cols[0])]):
        xs, ys = [], []
        for d in rows:
            xs.append(by[(d, cols[0])][i][1])
            if name == "head_logits":
                ys.append(torch.cat([by[(d, m)][i][2] for m in cols], dim=-1))
            else:
                ys.append(by[(d, cols[0])][i][2])
                same &= all(torch.equal(by[(d, m)][i][2], ys[-1]) for m in cols[1:])
        out.append((name, torch.cat(xs), torch.cat(ys)))
    return out, same
