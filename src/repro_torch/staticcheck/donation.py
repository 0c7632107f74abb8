"""SC-DON -- the pool updated in place (the JAX package's
``staticcheck/donation.py``, where every buffer a hot-path jit donates
must come back as an XLA input/output alias).

The port's hot path writes its buffers in place; the captured tick reads
and writes them by address. So every buffer a program is handed (each
pool leaf; for a tick also ``_tokens``, ``_pos``, ``_lane_active``,
``_lane_out`` and, when paged, the page tables) must keep its storage
across the call, and no node outside a kernel may allocate a tensor of a
whole pool leaf's shape and dtype: a pool rebuilt as a copy, even one
copied back, would stream the whole pool every call.
"""

from __future__ import annotations

from repro_torch.staticcheck.harness import HotProgram
from repro_torch.staticcheck.report import Finding

CHECK = "SC-DON"


def pool_copies(prog: HotProgram) -> list[str]:
    """Nodes (outside kernels) that return a new tensor of a pool leaf's
    shape and dtype."""
    leaves = {(t.shape, t.dtype) for t in prog.pool}
    storages = {t.storage for t in prog.pool}
    hits = []
    for node in prog.nodes:
        if node.kernel:
            continue
        for t in node.outputs:
            if (t.shape, t.dtype) in leaves and t.storage not in storages:
                hits.append(f"{node.op} -> {t.dtype}{t.shape}")
    return hits


def check_donation(programs: list[HotProgram]) -> list[Finding]:
    out = []
    for prog in programs:
        if not prog.handed:
            continue
        handed = len(prog.handed)
        kept = handed - len(prog.moved)
        copies = pool_copies(prog)
        ok = kept == handed and not copies
        detail = f"{kept}/{handed} handed buffers updated in place"
        if prog.moved:
            detail += f"; rebound: {', '.join(prog.moved)}"
        if copies:
            detail += f"; pool-sized copies: {'; '.join(sorted(set(copies)))}"
        out.append(Finding(
            check=CHECK, subject=prog.name, ok=ok, detail=detail,
            data={"in_place": kept, "donated": handed,
                  "rebound": list(prog.moved),
                  "pool_copies": sorted(set(copies))}))
    return out
