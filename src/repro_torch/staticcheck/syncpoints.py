"""SC-SYNC / SC-AST -- the sync-point budget (the JAX package's
``staticcheck/syncpoints.py``).

The serving loop's contract is *exactly one* host sync per decode tick:
the token block's fetch in ``ServeEngine.step_fetch``. Two passes keep
that true:

* **SC-SYNC** -- no node of a traced hot-path program is a host sync: a
  tensor read as a Python scalar (``aten._local_scalar_dense``:
  ``.item()``, ``int()``, ``float()``, ``bool()`` of a tensor), an op
  whose output size depends on the data (``nonzero``, ``masked_select``,
  ``_unique2``, ``repeat_interleave`` with tensor repeats and no
  ``output_size``, indexing with a boolean mask), ``is_nonzero``,
  ``equal``, or a copy from the program's device to the host. The ops of
  a kernel's plain version count: on the card they are one launch, but a
  sync among them would be the port's. On a CUDA device the traced call
  also runs under ``torch.cuda.set_sync_debug_mode("error")``
  (``harness.program_from_fn``), which names any synchronising CUDA
  call the node list cannot show.

* **SC-AST** -- a source-level scan of the port's ``serving/``,
  ``gateway/``, ``models/`` and ``paging/`` for calls that make the host
  wait on the device: ``float(x)``, ``np.asarray``/``np.array``,
  ``.block_until_ready()`` and their torch counterparts ``.item()``,
  ``.tolist()``, ``.cpu()``, ``.numpy()`` and ``torch.cuda.synchronize``.
  Every hit must either be in the sync inventory (the one per-tick
  fetch and the routing diagnostic) or carry a reviewed waiver in the
  port's ``staticcheck.toml``.
"""

from __future__ import annotations

import ast
import os

from repro_torch.staticcheck.harness import HotProgram
from repro_torch.staticcheck.report import Finding

CHECK_PROGRAM = "SC-SYNC"
CHECK_AST = "SC-AST"

#: aten ops that wait for the device whatever their arguments
SYNC_OPS = {"aten._local_scalar_dense", "aten.nonzero",
            "aten.masked_select", "aten._unique2", "aten.unique_dim",
            "aten.unique_consecutive", "aten.is_nonzero", "aten.equal"}
_INDEX_OPS = {"aten.index", "aten.index_put_", "aten.index_put",
              "aten._index_put_impl_"}
_COPY_OPS = {"aten._to_copy", "aten.copy_", "aten._copy_from"}

# The sync inventory: the sites that ARE the sync budget (the one
# per-tick fetch) or a reviewed diagnostic. Each entry is (path suffix,
# qualname, call).
SYNC_INVENTORY = [
    ("serving/engine.py", "ServeEngine.step_fetch", ".cpu"),
    ("serving/engine.py", "ServeEngine.step_fetch", ".numpy"),
    # MoE expert-load diagnostic: an explicit operator call, never on
    # the per-tick decode path
    ("serving/engine.py", "ServeEngine.routing_report", ".cpu"),
    ("serving/engine.py", "ServeEngine.routing_report", ".tolist"),
]

SCAN_DIRS = ("src/repro_torch/serving", "src/repro_torch/gateway",
             "src/repro_torch/models", "src/repro_torch/paging")


def _packet(op: str) -> str:
    """``aten.nonzero.default`` -> ``aten.nonzero``."""
    return op.rsplit(".", 1)[0] if op.count(".") >= 2 else op


def node_syncs(node, device: str) -> list[str]:
    """What makes ``node`` a host sync, if anything."""
    op = _packet(node.op)
    if op in SYNC_OPS:
        return [op]
    if op == "aten.repeat_interleave" and node.op.endswith(".Tensor") \
            and "output_size" not in node.kwargs:
        return [f"{op} without output_size"]
    if op in _INDEX_OPS and any(t.dtype == "bool" for t in node.inputs[1:]):
        return [f"{op} with a boolean mask"]
    if op in _COPY_OPS and device != "cpu" \
            and any(t.device == device for t in node.inputs) \
            and any(t.device == "cpu" for t in node.outputs):
        return [f"{op} to the host"]
    return []


def check_program_sync(programs: list[HotProgram]) -> list[Finding]:
    out = []
    for prog in programs:
        hits = []
        for node in prog.nodes:
            where = f" (in {node.kernel})" if node.kernel else ""
            hits.extend(h + where for h in node_syncs(node, prog.device))
        if prog.sync_error:
            hits.append(f"synchronising CUDA call: {prog.sync_error}")
        ok = not hits
        out.append(Finding(
            check=CHECK_PROGRAM, subject=prog.name, ok=ok,
            detail=("no host sync inside the program" if ok
                    else "host sync: " + "; ".join(sorted(set(hits)))),
            data={"hits": sorted(set(hits)), "nodes": len(prog.nodes),
                  "device": prog.device}))
    return out


# ---------------------------------------------------------------- AST pass

class _SyncCallScanner(ast.NodeVisitor):
    def __init__(self):
        self.stack: list[str] = []
        self.hits: list[tuple[int, str, str]] = []  # (line, qualname, call)

    def _qual(self) -> str:
        return ".".join(self.stack) or "<module>"

    def visit_ClassDef(self, node):
        self.stack.append(node.name)
        self.generic_visit(node)
        self.stack.pop()

    def visit_FunctionDef(self, node):
        self.stack.append(node.name)
        self.generic_visit(node)
        self.stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Call(self, node):
        call = _classify_call(node.func)
        if call is not None:
            self.hits.append((node.lineno, self._qual(), call))
        self.generic_visit(node)


_METHODS = ("block_until_ready", "item", "tolist", "cpu", "numpy")


def _classify_call(func: ast.expr):
    if isinstance(func, ast.Name) and func.id == "float":
        return "float"
    if not isinstance(func, ast.Attribute):
        return None
    if isinstance(func.value, ast.Name) and func.value.id in ("np", "numpy") \
            and func.attr in ("asarray", "array"):
        return f"np.{func.attr}"
    if func.attr == "synchronize" and isinstance(func.value, ast.Attribute) \
            and func.value.attr == "cuda" \
            and isinstance(func.value.value, ast.Name) \
            and func.value.value.id == "torch":
        return "torch.cuda.synchronize"
    if func.attr in _METHODS:
        return f".{func.attr}"
    return None


def scan_source(path: str, src: str, relpath: str = "") -> list[Finding]:
    """Scan one module's source for host-sync calls. Inventory sites
    report ok; everything else is a violation until waived."""
    rel = relpath or path
    tree = ast.parse(src, filename=path)
    scanner = _SyncCallScanner()
    scanner.visit(tree)
    out = []
    for line, qual, call in scanner.hits:
        inventoried = any(
            rel.endswith(suffix) and qual == q and call == c
            for suffix, q, c in SYNC_INVENTORY)
        subject = f"{rel}:{qual}:{call}"
        out.append(Finding(
            check=CHECK_AST, subject=subject, ok=inventoried,
            detail=(f"line {line}: {call}() "
                    + ("-- sync inventory" if inventoried
                       else "outside the sync inventory")),
            data={"line": line, "call": call}))
    return out


def check_ast_syncs(root: str) -> list[Finding]:
    out = []
    for d in SCAN_DIRS:
        full = os.path.join(root, d)
        if not os.path.isdir(full):
            continue
        for dirpath, dirs, files in os.walk(full):
            dirs.sort()
            for fname in sorted(files):
                if not fname.endswith(".py"):
                    continue
                path = os.path.join(dirpath, fname)
                rel = os.path.relpath(path, root)
                with open(path, "r") as fh:
                    out.extend(scan_source(path, fh.read(), rel))
    return out
