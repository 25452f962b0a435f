"""Probes of ``chip_smoke.py``'s phase 18 (f)-(i) on one H100, run from
the repo root:

    python3 chip_probe_grid.py layers   # where the sharded bf16 gap comes from
    python3 chip_probe_grid.py faults   # planted faults against the checks

``layers``: Zamba2-2.7B and xLSTM-350M at full width, one period, bf16,
served (prompt 512 + 8) on 2x2, 2x1 (data alone) and 1x2 (model alone)
grids of gloo ranks sharing the card; each prefill layer's input and
output on the grid against the unsharded run's and against the
unsharded layer on the grid's input; the unsharded prefill's moves with
each prompt alone, under random one-ulp noise on its embedding outputs
and against the same weights in f32; then one f32 train step's moves
under that noise and with the batch split into B=1 halves.
``PROBE_CPU=1`` runs it at the reduced sizes on the CPU.

``faults``: ``chip_smoke.py``'s unsharded references, then one spawn of
the 2x2 grid per planted fault (patched into the ranks' processes only:
a slice's backward without its all-gather, a norm without its row sum,
a bf16 cast of the FSDP reduce-scatter or of ``enter_model``'s
gradient, a slice of the wrong block, each row-parallel partial rounded
to bf16), each printing the readings (f)-(i) hold against their bars.
"""
import dataclasses
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.getcwd())
sys.path.insert(0, os.path.join(os.getcwd(), "src"))
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

ARCHS = {"hybrid": "zamba2_2_7b", "xlstm": "xlstm_350m"}
CPU = bool(os.environ.get("PROBE_CPU"))
DEV = "cpu" if CPU else "cuda"
LAYERS, B, P, GEN, SEED = 6, 2, (16 if CPU else 512), (2 if CPU else 8), 0
STEP_B, STEP_S = 2, (32 if CPU else 1024)
TAPPED = ("apply_mamba_layer", "apply_mlstm_layer", "apply_slstm_layer", "apply_ffn")


class Tap:
    """Records (name, x in, out) of the tapped layer functions during a
    prefill; with ``replay`` it feeds each call the recorded input instead."""

    def __init__(self, replay=None):
        self.calls, self.replay, self.on = [], replay, False

    def wrap(self, name, fn):
        def w(*args, **kw):
            if not self.on:
                return fn(*args, **kw)
            x = args[1]
            i = len(self.calls)
            if self.replay is not None:
                x = self.replay[i][1].to(x.device)
                args = (args[0], x) + args[2:]
            out = fn(*args, **kw)
            y = out[0] if isinstance(out, tuple) else out
            self.calls.append((name, x.detach().cpu(), y.detach().cpu()))
            return out
        return w

    def install(self):
        from repro_torch.models import blocks, hybrid_model, xlstm_model
        self.saved = []
        for mod, name in ([(blocks, n) for n in TAPPED]
                          + [(hybrid_model, "_attention_collect_kv"), (hybrid_model, "head_logits"),
                             (xlstm_model, "head_logits")]):
            f = getattr(mod, name)
            self.saved.append((mod, name, f))
            setattr(mod, name, self.wrap(name, f))
        for cls in (hybrid_model.HybridModel, xlstm_model.XLSTMModel):
            pf = cls.prefill
            self.saved.append((cls, "prefill", pf))

            def prefill(model, *a, _pf=pf, **k):
                self.on = True
                try:
                    return _pf(model, *a, **k)
                finally:
                    self.on = False
            setattr(cls, "prefill", prefill)
        return self

    def remove(self):
        for mod, name, f in self.saved:
            setattr(mod, name, f)


def rank_fn(group, mp, spool, tag):
    from repro_torch.launch import serve as serve_lib
    out = {}
    for key, arch in ARCHS.items():
        tap = Tap().install()
        try:
            res = serve_lib.serve_rank(group, arch, mp, {
                "batch": B, "prompt_len": P, "gen_len": GEN, "reduced": CPU, "seed": SEED,
                "params": None, "layers": LAYERS})
        finally:
            tap.remove()
        path = os.path.join(spool, f"g{mp}_{tag}_r{group.rank}_{key}.pt")
        torch.save(tap.calls, path)
        out[key] = {"calls": path, "logits": res["prefill_logits"], "tokens": res["tokens"]}
        torch.cuda.empty_cache() if not CPU else None
    from repro_torch.launch import mesh as mesh_lib
    grid = mesh_lib.make_host_mesh(group, mp)
    out["coords"] = grid.coords
    return out


def merge(ranks, key):
    """Whole-batch records from the ranks' shards."""
    calls = [torch.load(r[key]["calls"]) for r in ranks]
    rows = sorted({r["coords"]["data"] for r in ranks})
    mps = sorted({r["coords"]["model"] for r in ranks})
    by = {(r["coords"]["data"], r["coords"]["model"]): c for r, c in zip(ranks, calls)}
    merged, model_same = [], True
    for k in range(len(calls[0])):
        name = calls[0][k][0]
        xs, ys = [], []
        for d in rows:
            xs.append(by[(d, 0)][k][1])
            if name == "head_logits":
                ys.append(torch.cat([by[(d, m)][k][2] for m in mps], dim=-1))
            else:
                ys.append(by[(d, 0)][k][2])
                for m in mps[1:]:
                    model_same &= bool(torch.equal(by[(d, m)][k][2], by[(d, 0)][k][2]))
        merged.append((name, torch.cat(xs, 0), torch.cat(ys, 0)))
    return merged, model_same


def ulp(t):
    t = t.float().abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(t)) - 7)


def gap(a, b):
    a, b = a.float(), b.float()
    d = (a - b).abs()
    return {"rel": float(d.max() / b.abs().max()), "ulps": float((d / ulp(b)).max()),
            "frac": float((d > 0).float().mean())}


def fmt(g):
    return f"{g['rel']:.3e} x max ({g['ulps']:.1f} ulps, {g['frac']:.2e} differ)"


def unsharded(key, arch, replay=None, params=None, cfg=None, tokens=None, noise=None):
    from repro_torch.launch.train import _config
    from repro_torch.launch.serve import _prompt
    from repro_torch.models import build_model, hybrid_model, xlstm_model
    cfg = cfg or _config(arch, CPU, LAYERS)
    model = build_model(cfg)
    if params is None:
        params = model.init(torch.Generator(device=DEV).manual_seed(SEED))
    if tokens is None:
        tokens = _prompt(cfg, B, P, SEED)["tokens"]
    module = hybrid_model if key == "hybrid" else xlstm_model
    embed = module.embed_tokens
    if noise is not None:
        def noisy(*a):
            e = embed(*a)
            g = torch.Generator(device=e.device).manual_seed(noise)
            r = torch.randint(0, 4, e.shape, generator=g, device=e.device)
            up = torch.nextafter(e, torch.full_like(e, float("inf")))
            dn = torch.nextafter(e, torch.full_like(e, -float("inf")))
            return torch.where(r == 0, up, torch.where(r == 1, dn, e))
        module.embed_tokens = noisy
    tap = Tap(replay).install()
    try:
        with torch.no_grad():
            logits, _ = model.prefill(params, {"tokens": torch.as_tensor(tokens, device=DEV)},
                                      max_len=P + GEN)
    finally:
        tap.remove()
        module.embed_tokens = embed
    return logits[:, -1].float().cpu(), tap.calls, params, cfg


def serve_probe():
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.serve import _prompt
    spool = tempfile.mkdtemp(dir=os.getcwd(), prefix=".chip_smoke_probe_")
    grids = {}
    for ranks, mp in ((4, 2), (2, 1), (2, 2)):
        t0 = time.perf_counter()
        grids[(ranks // mp, mp)] = mesh_lib.spawn_workers(rank_fn, ranks, mp, spool, ranks,
                                                          backend="gloo", device=DEV,
                                                          join_timeout_s=600)
        print(f"grid {ranks // mp}x{mp} done in {time.perf_counter() - t0:.1f} s", flush=True)
    for key, arch in ARCHS.items():
        want, ucalls, params, cfg = unsharded(key, arch)
        scale = float(want.abs().max())
        print(f"== {arch} bf16 prefill B={B} P={P}: max|logits| {scale:.4f}", flush=True)
        # one card, each prompt alone
        toks = _prompt(cfg, B, P, SEED)["tokens"]
        alone = torch.cat([unsharded(key, arch, params=params, cfg=cfg, tokens=toks[i:i + 1])[0]
                           for i in range(B)])
        print(f"one card B=1 each vs B=2: {fmt(gap(alone, want))}", flush=True)
        for s in range(3):
            moved = unsharded(key, arch, params=params, cfg=cfg, noise=s)[0]
            print(f"one card, random +-1 ulp (p 1/4 each) on embeddings, seed {s}: "
                  f"{fmt(gap(moved, want))}", flush=True)
        p32 = {k: v for k, v in params.items()}
        from repro_torch import _tree
        p32 = _tree.map_(lambda t: t.float(), params)
        c32 = dataclasses.replace(cfg, dtype="float32")
        ref32 = unsharded(key, arch, params=p32, cfg=c32)[0]
        print(f"bf16 unsharded vs f32 model (same weights): {fmt(gap(want, ref32))}", flush=True)
        print(f"B=1 each vs f32 model: {fmt(gap(alone, ref32))}", flush=True)
        for shape, ranks in grids.items():
            merged, same = merge(ranks, key)
            got = torch.as_tensor(ranks[0][key]["logits"])
            agree = float((ranks[0][key]["tokens"] == ranks[0][key]["tokens"]).mean())
            print(f"-- grid {shape}: logits vs unsharded {fmt(gap(got, want))}; vs f32 "
                  f"{fmt(gap(got, ref32))}; model ranks equal {same}", flush=True)
            _, rcalls, _, _ = unsharded(key, arch, replay=merged, params=params, cfg=cfg)
            for k, ((name, gx, gy), (_, ux, uy), (_, rx, ry)) in enumerate(
                    zip(merged, ucalls, rcalls)):
                print(f"   {k} {name}: input vs unsharded's {fmt(gap(gx, ux))}; output vs the "
                      f"unsharded layer on the same input {fmt(gap(gy, ry))}", flush=True)
        del params
        torch.cuda.empty_cache() if not CPU else None


def step_probe():
    from repro_torch import _tree
    from repro_torch.data import TokenStream
    from repro_torch.launch.train import _config
    from repro_torch.models import build_model, hybrid_model, xlstm_model
    from repro_torch.models.steps import make_grad_fn
    for key, arch in ARCHS.items():
        cfg = dataclasses.replace(_config(arch, CPU, LAYERS), dtype="float32")
        model = build_model(cfg)
        params = model.init(torch.Generator(device=DEV).manual_seed(SEED))
        whole = next(iter(TokenStream(cfg.vocab_size, STEP_S, STEP_B, seed=0)))
        batch = {k: torch.as_tensor(v, device=DEV) for k, v in whole.items()}
        grad_fn = make_grad_fn(model)
        module = hybrid_model if key == "hybrid" else xlstm_model
        embed = module.embed_tokens

        def run(b, noise=None):
            if noise is not None:
                def noisy(*a):
                    e = embed(*a)
                    g = torch.Generator(device=e.device).manual_seed(noise)
                    r = torch.randint(0, 4, e.shape, generator=g, device=e.device)
                    up = torch.nextafter(e, torch.full_like(e, float("inf")))
                    dn = torch.nextafter(e, torch.full_like(e, -float("inf")))
                    return e + (torch.where(r == 0, up, torch.where(r == 1, dn, e)) - e).detach()
                module.embed_tokens = noisy
            try:
                loss, g = grad_fn(params, b)
            finally:
                module.embed_tokens = embed
            return float(loss), _tree.map_(lambda t: t.detach().cpu(), g)

        def norm(g):
            return float(sum(float((t.double() ** 2).sum()) for t in _tree.leaves(g)) ** 0.5)

        def cmp(label, l1, g1, l0, g0):
            worst = max(float((a - w).abs().max() / w.abs().max().clamp_min(1e-30))
                        for a, w in zip(_tree.leaves(g1), _tree.leaves(g0)))
            print(f"{arch} f32 step {label}: loss {abs(l1 - l0) / abs(l0):.3e}, grad_norm "
                  f"{abs(norm(g1) - norm(g0)) / norm(g0):.3e}, worst leaf {worst:.3e} x max",
                  flush=True)

        l0, g0 = run(batch)
        halves = [run({k: v[i:i + 1] for k, v in batch.items()}) for i in range(STEP_B)]
        lh = sum(h[0] for h in halves) / STEP_B
        gh = _tree.map_(lambda *t: sum(t) / STEP_B, *[h[1] for h in halves])
        cmp("B=1 halves averaged vs B=2", lh, gh, l0, g0)
        for s in range(3):
            ln, gn = run(batch, noise=s)
            cmp(f"random +-1 ulp on embeddings seed {s}", ln, gn, l0, g0)
        del params
        torch.cuda.empty_cache() if not CPU else None


def layers_main():
    t0 = time.perf_counter()
    try:
        serve_probe()
    finally:
        for d in os.listdir(os.getcwd()):
            if d.startswith(".chip_smoke_probe_"):
                shutil.rmtree(d, ignore_errors=True)
    print(f"serve probe {time.perf_counter() - t0:.1f} s", flush=True)
    step_probe()
    print(f"done {time.perf_counter() - t0:.1f} s", flush=True)


FAULTS = ["none", "slice_grad_local", "norm_local", "bf16_grad_scatter", "bf16_enter_grad",
          "slice_other", "double_round"]


def plant(fault):
    from repro_torch.sharding import parallel as par
    if fault == "slice_grad_local":
        def bw(ctx, g):
            n = g.shape[ctx.dim]
            out = g.new_zeros(g.shape[:ctx.dim] + (n * ctx.transport.size,) + g.shape[ctx.dim + 1:])
            out.narrow(ctx.dim, ctx.transport.rank * n, n).copy_(g)
            return out, None, None
        par._Slice.backward = staticmethod(bw)
    elif fault == "norm_local":
        par._SumModel.forward = staticmethod(lambda ctx, x, t: (setattr(ctx, "transport", t), x.clone())[1])
    elif fault == "bf16_grad_scatter":
        orig = par._Gather.backward

        def bw(ctx, g):
            out = orig(ctx, g)
            return (out[0].to(torch.bfloat16).to(out[0].dtype),) + out[1:]
        par._Gather.backward = staticmethod(bw)
    elif fault == "bf16_enter_grad":
        orig = par._EnterModel.backward

        def bw(ctx, g):
            out = orig(ctx, g)
            return out[0].to(torch.bfloat16).to(out[0].dtype), None
        par._EnterModel.backward = staticmethod(bw)
    elif fault == "slice_other":
        def fw(ctx, x, transport, dim):
            ctx.transport, ctx.dim = transport, dim
            n = x.shape[dim] // transport.size
            return x.narrow(dim, ((transport.rank + 1) % transport.size) * n, n).clone()
        par._Slice.forward = staticmethod(fw)
    elif fault == "double_round":
        orig = par.matmul_f32
        par.matmul_f32 = lambda a, b: orig(a, b).to(a.dtype).float()


def fault_rank(group, spool, fault):
    import numpy as np
    import torch

    plant(fault)
    from repro_torch.launch import mesh as mesh_lib
    grid = mesh_lib.make_host_mesh(group, cs.SHARDED["model_parallel"])
    out = {}
    for key in cs.SHARDED_RECURRENT:
        out[key] = cs._recurrent_rank(torch, np, group, grid, os.path.join(spool, fault), key)
        cs.free(torch)
    return out


def readings(ranks, ref, key):
    from repro_torch import _tree
    from repro_torch.launch.mesh import MeshPlan
    from repro_torch.sharding import rules as rules_lib
    plan = MeshPlan(("data", "model"), (2, 2))
    got = rules_lib.unshard_params(
        [{"x": cs._unspool(torch, r[key]["logits"]).numpy()} for r in ranks],
        {"x": ("data", None, "model")}, plan)["x"]
    want = ref["logits"]
    f = float(np.abs(got - want).max() / np.abs(want).max())
    fbar = max(cs.SHARDED_RECURRENT_TOL, cs.SHARDED_ULP_RESPONSES * ref["ulp_response"]
               / float(np.abs(want).max()))
    specs = rules_lib.param_specs(ref["step_cfg"], rules_lib.AxisRules(
        mesh=plan, data_axes=("data",), model_axis="model"), plan)
    got_g = rules_lib.unshard_params([cs._unspool(torch, r[key]["grads"]) for r in ranks],
                                     specs, plan)
    leaf = max(float((g - w).abs().max() / w.abs().max().clamp_min(1e-30))
               for g, w in zip(_tree.leaves(got_g), _tree.leaves(ref["grads"])))
    r0 = ranks[0][key]
    h = {"loss": abs(r0["loss"] - ref["loss"]) / abs(ref["loss"]),
         "grad_norm": abs(r0["grad_norm"] - ref["grad_norm"]) / ref["grad_norm"], "leaf": leaf}
    hbar = {k: max(v, cs.SHARDED_STEP_NOISE * ref["step_noise_response"][k])
            for k, v in cs.GRAD_TOL.items()}
    layers = cs.sharded_serve_layers(torch, key, ranks)
    g = torch.from_numpy(r0["serve"]["prefill_logits"])
    w = torch.from_numpy(ref["serve"]["prefill_logits"])
    e, sc = cs.max_err(g, w)
    to32 = cs.max_err(g, ref["serve_f32"])[0], cs.max_err(w, ref["serve_f32"])[0]
    i = {"layer_worst": layers["worst"], "layer_name": layers["name"], "rows": layers["rows_agree"],
         "e2e": e / sc, "e2e_bar": ref["serve_noise_response"] / sc,
         "to_f32": to32[0] / sc, "to_f32_bar": (to32[1] + cs.SHARDED_SERVE_TOL * sc) / sc}
    return {"f": (f, fbar), "h": (h, hbar), "i": i}


def faults_main():
    refs = {}
    t0 = time.perf_counter()
    for key in cs.SHARDED_RECURRENT:
        refs[key] = cs.sharded_recurrent_reference(torch, np, key)
        print(f"{key} reference: step noise response {refs[key]['step_noise_response']}, serve "
              f"noise response {refs[key]['serve_noise_response']:.3e}", flush=True)
    print(f"references {time.perf_counter() - t0:.1f} s", flush=True)
    spool = tempfile.mkdtemp(dir=os.getcwd(), prefix=".chip_smoke_faults_")
    from repro_torch.launch import mesh as mesh_lib
    try:
        for fault in FAULTS:
            os.makedirs(os.path.join(spool, fault))
            t0 = time.perf_counter()
            ranks = mesh_lib.spawn_workers(fault_rank, 4, spool, fault, backend="gloo",
                                           device="cuda", join_timeout_s=600)
            for key in cs.SHARDED_RECURRENT:
                r = readings(ranks, refs[key], key)
                f, fbar = r["f"]
                h, hbar = r["h"]
                fails = []
                if f > fbar:
                    fails.append("f/g")
                if any(h[k] > hbar[k] for k in h):
                    fails.append("h")
                i = r["i"]
                if (i["layer_worst"] > cs.SHARDED_SERVE_TOL or not i["rows"]
                        or i["e2e"] > i["e2e_bar"] or i["to_f32"] > i["to_f32_bar"]):
                    fails.append("i")
                print(f"FAULT {fault} {key}: caught by {fails}; forward {f:.3e} (bar {fbar:.3e}); "
                      f"step loss {h['loss']:.3e} grad_norm {h['grad_norm']:.3e} leaf "
                      f"{h['leaf']:.3e} (bars {hbar}); serve layer worst {i['layer_worst']:.3e} "
                      f"({i['layer_name']}, rows {i['rows']}) e2e {i['e2e']:.3e} (bar "
                      f"{i['e2e_bar']:.3e}) to_f32 {i['to_f32']:.3e} (bar {i['to_f32_bar']:.3e})",
                      flush=True)
            print(f"fault {fault} {time.perf_counter() - t0:.1f} s", flush=True)
    finally:
        shutil.rmtree(spool, ignore_errors=True)


if __name__ == "__main__":
    if sys.argv[1:] == ["layers"]:
        layers_main()
    elif sys.argv[1:] == ["faults"]:
        faults_main()
    else:
        sys.exit("usage: python3 chip_probe_grid.py layers|faults")
