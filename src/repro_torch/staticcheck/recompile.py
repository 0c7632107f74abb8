"""SC-RECOMP -- no recapture across ticks (the JAX package's
``staticcheck/recompile.py``, where the serving jit caches must be keyed
so that steady-state traffic never retraces).

The port's counterpart of a compiled tick is the CUDA graph a card
engine captures once per tick size (``ServeEngine._replay``), and of the
compiled weights the serving tree ``ServeEngine._served`` that
``Model.prepare_serving`` makes once. On a live engine:

* **on the card**: two ticks of one size make exactly one capture, the
  second tick replaying it; an admission between ticks causes no
  recapture and no new graph; a tick of a new size adds exactly one
  graph (``captures``, ``replays``, ``len(_graphs)``);
* **on both devices**: the served weights keep their identity and
  storage across ticks and admissions, and two admissions of the same
  bucket allocate no tensor of a weight's shape and dtype outside a
  kernel call.

A violation means a tick or an admission rebuilds per call what should
be built once: the silent serving regression this check makes loud.
"""

from __future__ import annotations

import numpy as np

from repro_torch.serving.engine import AudioRequest, Request
from repro_torch.staticcheck.harness import BUCKET, DECODE_BLOCK, ENC_S, \
    SEED, _tag
from repro_torch.staticcheck.report import Finding
from repro_torch.staticcheck.trace import meta, tensors, trace_call

CHECK = "SC-RECOMP"


def _served(eng) -> list:
    return list(tensors((eng._served, eng._draft_served)))


def _identity(eng) -> list:
    return [(id(t), t.untyped_storage().data_ptr()) for t in _served(eng)]


def weight_allocs(weights: list, nodes) -> list[str]:
    """Nodes outside kernels that return a new tensor of the shape and
    dtype of one of ``weights`` (TensorMeta of the served matrices)."""
    shapes = {(t.shape, t.dtype) for t in weights}
    storages = {t.storage for t in weights}
    return sorted({f"{n.op} -> {t.dtype}{t.shape}" for n in nodes
                   if not n.kernel for t in n.outputs
                   if (t.shape, t.dtype) in shapes
                   and t.storage not in storages})


def _request(eng, uid: int, n: int):
    """A request whose lane stays active through the check's ticks (no
    EOS id, a budget past them), with ``n`` prompt tokens."""
    kw = dict(uid=uid, tokens=list(range(3, 3 + n)), max_new=24, eos_id=-1)
    if not eng.enc_dec:
        return Request(**kw)
    rng = np.random.default_rng(SEED + uid)
    x = rng.standard_normal((ENC_S, eng.model.cfg.d_model)) * 0.5
    return AudioRequest(enc_frames=x.astype(np.float32), **kw)


def check_recompile(eng) -> list[Finding]:
    """The two findings of one engine, which must have no active lane:
    its decode tick and its prefill. Admits two requests and leaves them
    active."""
    ptag = "paged_" if eng.paged else ""
    dtag = _tag(eng)
    captured = eng.cuda_graph
    ids = _identity(eng)
    weights = [meta(t) for t in _served(eng) if t.dim() >= 2]
    # two prompts of one bucket (exact-length engines: one length)
    n = BUCKET - 3 if eng.spec.prefill_exact else 4
    lens = (n, n) if eng.spec.prefill_exact else (n, n + 1)
    st, nodes = trace_call(eng.admit, _request(eng, 1, lens[0]))
    allocs = weight_allocs(weights, nodes)
    k, k_new = DECODE_BLOCK, 2 * DECODE_BLOCK
    eng.step(k)
    eng.step(k)
    first = (eng.captures, eng.replays, len(eng._graphs))
    st2, nodes = trace_call(eng.admit, _request(eng, 2, lens[1]))
    allocs += weight_allocs(weights, nodes)
    eng.step(k)
    admitted = (eng.captures, eng.replays, len(eng._graphs))
    eng.step(k_new)
    eng.step(k_new)
    grown = (eng.captures, eng.replays, len(eng._graphs))
    same = _identity(eng) == ids
    live = st is not None and st2 is not None and eng.n_active == 2
    if captured:
        graphs_ok = first == (1, 1, 1) and admitted == (1, 2, 1) \
            and grown == (2, 3, 2)
        what = (f"2 ticks -> {first[0]} capture(s), {first[1]} replay(s); "
                f"an admission between ticks -> +{admitted[0] - first[0]} "
                f"capture(s), +{admitted[2] - first[2]} graph(s); a new "
                f"size -> +{grown[2] - admitted[2]} graph(s)")
    else:
        graphs_ok = grown == (0, 0, 0)
        what = "eager ticks (no capture on this device)"
    ok = graphs_ok and same and live
    out = [Finding(
        check=CHECK, subject=f"{ptag}decode_block{dtag}", ok=ok,
        detail=f"{what}; served weights "
               f"{'kept' if same else 'REBUILT'} across ticks"
               + ("" if live else "; a lane did not stay active"),
        data={"captured": captured, "first": list(first),
              "after_admission": list(admitted), "new_size": list(grown),
              "served_weights_kept": same})]
    ok = not allocs and same and live
    out.append(Finding(
        check=CHECK, subject=f"{ptag}prefill{dtag}", ok=ok,
        detail=(f"2 same-bucket admits -> {len(allocs)} weight-sized "
                f"allocation(s); served weights "
                f"{'kept' if same else 'REBUILT'}"
                + (f": {'; '.join(allocs)}" if allocs else "")),
        data={"weight_allocs": allocs, "served_weights_kept": same}))
    return out
