"""SC-DTYPE -- dtype-plane integrity: the cache pools and the other
storage-dtype planes must never be materialized in f32 inside a hot-path
program (the JAX package's ``staticcheck/dtypeplanes.py``).

The paper's cache-stream ratio (q8_0 at 0.5312x the bf16 bytes) only
holds if reads take the stored dtype into the compute at the point of
use: an f32 copy of a whole plane streams 4-byte planes through HBM
whatever the pool stores. The check walks every node outside a kernel
and flags those that make float32 from an int8, uint8, bf16 or f16
input that is

* plane-sized: at least ``n_slots * min(seq) * head_dim`` elements, with
  a pool sequence dim (``max_len`` or ``enc_len``) in its shape, not a
  recurrent-state or routing plane (read-upcast into f32 compute by
  design), and
* materialized: the f32 output holds at least as many elements as that
  input (an explicit ``_to_copy`` / ``copy_``, or type promotion inside
  an elementwise op). A product that takes the bf16 plane as its
  operand into an f32 result of another shape (``bmm`` with
  ``out_dtype``) reads the plane as stored.

The inside of a kernel call (the plain version's ops on the CPU) is left
to the kernel it stands for: on the card it is a hand-written kernel
reading the stored planes. Per-token activation upcasts (argmax logits,
softmax accumulators, all far below plane size) pass.

``check_recurrent_state`` pins the recurrent planes' storage dtype: one
tick must hand back every cache leaf in the dtype it received it (the
state is computed in f32 inside a block and cast back on write).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.api import use_context
from repro_torch.staticcheck.harness import DECODE_BLOCK, HotProgram, _walk
from repro_torch.staticcheck.report import Finding
from repro_torch.staticcheck.trace import STORAGE_DTYPES

CHECK = "SC-DTYPE"


def _plane_upcasts(prog: HotProgram) -> list[dict]:
    n_slots, max_len, enc_len, head_dim = prog.plane_dims
    # enc_len is 0 for decoder-only engines: no cross pool, so only
    # max_len counts as a pool sequence dim
    seq_dims = {d for d in (max_len, enc_len) if d}
    min_elems = n_slots * min(seq_dims) * head_dim
    state_shapes = set(prog.state_shapes)
    hits = []
    for node in prog.nodes:
        if node.kernel or node.is_kernel:
            continue
        widest = max((t.numel for t in node.outputs
                      if t.dtype == "float32"), default=0)
        for t in node.inputs:
            if t.dtype not in STORAGE_DTYPES or t.numel < min_elems \
                    or not seq_dims & set(t.shape) \
                    or t.shape in state_shapes or widest < t.numel:
                continue
            hits.append({"from": t.dtype, "shape": list(t.shape),
                         "op": node.op})
    return hits


def check_dtype_planes(programs: list[HotProgram]) -> list[Finding]:
    """One finding per distinct (program, source dtype, shape) upcast --
    narrow enough for a waiver to cover exactly one materialization site
    without masking future leaks -- plus one ok finding for each clean
    program."""
    out = []
    for prog in programs:
        if not prog.plane_dims or not prog.cache_dtypes:
            continue
        groups: dict[str, list[dict]] = {}
        for h in _plane_upcasts(prog):
            key = f"{h['from']}{tuple(h['shape'])}"
            groups.setdefault(key, []).append(h)
        if not groups:
            out.append(Finding(
                check=CHECK, subject=prog.name, ok=True,
                detail="no plane-sized f32 upcast",
                data={"cache_dtypes": list(prog.cache_dtypes)}))
            continue
        for key, hits in sorted(groups.items()):
            ops = sorted({h["op"] for h in hits})
            out.append(Finding(
                check=CHECK, subject=f"{prog.name}:{key}", ok=False,
                detail=(f"{len(hits)} plane-sized f32 upcast(s) of "
                        f"{key} ({', '.join(ops)}) -- the pool would "
                        f"stream 4-byte planes"),
                data={"upcasts": hits,
                      "cache_dtypes": list(prog.cache_dtypes)}))
    return out


def check_recurrent_state(engines: list) -> list[Finding]:
    """Recurrent-carry dtype stability: one decode tick must hand back
    every cache leaf in the dtype it received it, in particular the
    constant-size recurrent buffers (``ssm`` / ``mstate`` / ``sstate``
    lanes), whose blocks compute in f32 and must cast back to storage on
    write. Engines whose spec declares no recurrent state are skipped:
    their planes are covered by the node walk above."""
    out = []
    for eng in engines:
        if not eng.spec.recurrent:
            continue
        cfg = eng.model.cfg
        before = {p: t.dtype for p, t in _walk(eng.cache)}
        with torch.no_grad(), use_context(eng.dispatch_ctx):
            eng._tick(DECODE_BLOCK)
        after = {p: t.dtype for p, t in _walk(eng.cache)}
        drift = [f"{p}: {before[p]} -> {after.get(p)}"
                 for p in before if after.get(p) != before[p]]
        ok = not drift
        out.append(Finding(
            check=CHECK,
            subject=f"recurrent_state[{cfg.name}|{eng.cache_dtype}]",
            ok=ok,
            detail=("decode carry is a dtype fixed point "
                    f"({'/'.join(eng.spec.recurrent)} state stays "
                    "storage-width)" if ok else
                    "decode tick widens cache leaves: "
                    + "; ".join(drift)),
            data={"recurrent_kinds": list(eng.spec.recurrent),
                  "drift": drift}))
    return out
