"""Build and trace the port's serving hot path (the JAX package's
``staticcheck/harness.py``).

The harness instantiates the reference harness's engines, from the
port's ``reduced`` configs and seeded weights (``torch.Generator``), at
its pool geometry, and traces (``trace.Tracer``) the hot-path
programs under the reference's names:

* ``decode_block``       -- one tick, ``ServeEngine._tick(DECODE_BLOCK)``
                            (the body the card captures in a CUDA graph)
* ``prefill``            -- the device part of an admission's prefill
                            (``_prefill_device``: the forward, the pool
                            write and the first token's argmax; the
                            admission fetches that token outside it)
* ``extend_cross_cache`` -- a stream's in-place cross-K/V extension
                            (``engine._extend_cross_cache``)
* ``frontend_gemm``      -- ``audio.features.mel_to_frames``

Paged engines (``repro_torch.paging``) trace ``paged_decode_block``,
``paged_prefill`` and ``paged_extend_cross`` under the same checks.

Tracing executes, where the reference's ``jitted.trace`` does not: each
program runs once, on engines with no active lane (parked lanes decode
at position 0, masked), on the buffers the engine serves from. A
``HotProgram`` keeps the storage of every buffer the program is handed
(each pool leaf; for a tick also the decode-state buffers and the page
tables) before and after the call. On a CUDA device every traced call
runs under ``torch.cuda.set_sync_debug_mode("error")``, and a call that
synchronises is recorded as such. ``frontend_gemm`` runs once before its
trace: its fixed projection is copied to the device at the first call,
as the reference bakes it into its jit.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.kernels import api
from repro_torch.kernels.api import use_context
from repro_torch.models import encdec
from repro_torch.models.model import _KV_PLANE_KEYS, build
from repro_torch.platforms import resolve_device
from repro_torch.quantize import quantize_tree
from repro_torch.serving.engine import ServeEngine, _extend_cross_cache
from repro_torch.staticcheck.trace import Tracer, meta

# The reference harness's geometry: the same pool, so the verdicts of
# both packages cover the same programs.
N_SLOTS, MAX_LEN, ENC_LEN = 4, 64, 16
DECODE_BLOCK, BUCKET, ENC_S = 2, 32, 8
# Paged pool geometry: usable pages == the slot pool's token capacity
# (+1 for the reserved scratch page 0).
PAGE_SIZE = 8
N_PAGES = N_SLOTS * (MAX_LEN // PAGE_SIZE) + 1
N_CROSS_PAGES = N_SLOTS * (ENC_LEN // PAGE_SIZE) + 1
# new encoder positions of a traced cross extension
S_NEW = 4
SEED = 0

# The model-zoo engines: one decoder-only arch per served family
# (KV-only dense, KV+routing MoE, hybrid KV+ssm, pure-recurrent xlstm).
FAMILY_ARCHS = ("qwen3-4b", "qwen3-moe-30b-a3b", "zamba2-7b",
                "xlstm-350m")

#: the serving geometry of ``chip_smoke.py``'s paged phases, for
#: whisper-tiny.en at full width (``full=True``)
FULL_GEOMETRY = dict(n_slots=4, max_len=64, enc_len=1504, page_size=8)

_STATE = ("_tokens", "_pos", "_lane_active", "_lane_out")


@dataclasses.dataclass
class HotProgram:
    """One traced hot-path program plus the facts the checks need."""

    name: str
    nodes: list                # trace.Node, in dispatch order
    handed: tuple = ()         # (path, TensorMeta) of each handed buffer
    moved: tuple = ()          # paths whose buffer changed storage
    pool: tuple = ()           # TensorMeta of each pool leaf
    cache_dtypes: tuple = ()   # storage dtypes of the pool
    plane_dims: tuple = ()     # (n_slots, max_len, enc_len, head_dim);
                               # enc_len 0 for decoder-only engines
    state_shapes: tuple = ()   # shapes of non-KV (recurrent/routing)
                               # cache planes, read-upcast by design
    device: str = "cpu"        # the device type the program ran on
    sync_error: str = ""       # a synchronising call's error (CUDA)


def _walk(tree, path: str = ""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, f"{path}.{k}")
    elif tree is not None:
        yield path, tree


def engine_buffers(eng: ServeEngine, state: bool = False) -> dict:
    """The buffers a program of ``eng`` is handed, by path: every pool
    leaf; with ``state`` the decode-state buffers a tick updates and,
    when paged, the page tables."""
    out = {f"cache{p}": t for p, t in _walk(eng.cache)}
    if state:
        out.update({name: getattr(eng, name) for name in _STATE})
        if eng.paged:
            out.update({f"pages.{k}": t
                        for k, t in eng.page_tables.items()})
    return out


def state_shapes(cache) -> tuple:
    """Shapes of the cache leaves that are *not* KV planes (recurrent
    state and routing counters), with each one's per-layer view."""
    shapes = set()

    def walk(tree):
        if isinstance(tree, dict):
            if set(tree) in _KV_PLANE_KEYS:
                return
            for v in tree.values():
                walk(v)
        elif tree is not None:
            shape = tuple(tree.shape)
            shapes.add(shape)
            if len(shape) > 1:
                shapes.add(shape[1:])

    walk(cache)
    return tuple(sorted(shapes))


def _dtype(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def program_from_fn(name: str, fn: Callable, *args,
                    handed: Optional[Callable[[], dict]] = None,
                    eng: Optional[ServeEngine] = None, device=None,
                    **facts) -> HotProgram:
    """Trace ``fn(*args)`` as a HotProgram on ``device`` (default: the
    engine's, else the handed buffers', else the CPU). ``handed``: a
    callable giving the buffers the program is handed, by path, called
    before and after the run. The copy rule guards the engine's pool
    leaves, else the handed buffers. ``facts``: HotProgram fields
    (``plane_dims``, ``cache_dtypes``, ...), filled from ``eng`` when
    given. The hook the seeded-violation tests use."""
    before = dict(handed()) if handed is not None else {}
    pool = list(before.values())
    if eng is not None:
        cfg = eng.model.cfg
        leaves = [t for _, t in _walk(eng.cache)]
        facts.setdefault("cache_dtypes",
                         tuple(sorted({_dtype(t) for t in leaves})))
        facts.setdefault("plane_dims", (
            eng.n_slots, eng.max_len, eng.enc_len if eng.enc_dec else 0,
            cfg.head_dim))
        facts.setdefault("state_shapes", state_shapes(eng.cache))
        pool = leaves
        device = eng.device if device is None else device
    if device is None:
        device = pool[0].device if pool else "cpu"
    on_cuda = torch.device(device).type == "cuda"
    pool_meta = tuple(meta(t) for t in pool)
    sync_error, tracer = "", Tracer()
    if on_cuda:
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.no_grad(), tracer, api.kernel_hook(tracer.kernel):
            fn(*args)
    except RuntimeError as e:
        if "synchroniz" not in str(e):
            raise
        sync_error = str(e).splitlines()[0]
    finally:
        if on_cuda:
            torch.cuda.set_sync_debug_mode(mode)
    after = dict(handed()) if handed is not None else {}
    moved = tuple(p for p, t in before.items()
                  if p not in after or meta(after[p]) != meta(t))
    return HotProgram(name=name, nodes=tracer.nodes,
                      handed=tuple((p, meta(t)) for p, t in before.items()),
                      moved=moved, pool=pool_meta,
                      device="cuda" if on_cuda else "cpu",
                      sync_error=sync_error, **facts)


# ----------------------------------------------------------------------------
# engines
# ----------------------------------------------------------------------------

def _model(arch: str, device, full: bool = False):
    cfg = get_config(arch)
    model = build(cfg if full else reduced(cfg))
    params = model.init_values(torch.Generator().manual_seed(SEED),
                               device=device)
    return model, params


def _geometry(full: bool) -> dict:
    if full:
        return dict(FULL_GEOMETRY)
    return dict(n_slots=N_SLOTS, max_len=MAX_LEN, enc_len=ENC_LEN,
                page_size=PAGE_SIZE)


def build_engine(cache_dtype: str = "q8_0", arch: str = "whisper-tiny-en",
                 device=None, *, spec_k: int = 0, paged: bool = False,
                 full: bool = False, pair=None) -> ServeEngine:
    """An engine of the harness's geometry (``full``: the arch at its
    published width, at ``FULL_GEOMETRY``) on ``device`` (default
    ``cuda``). ``spec_k``: a self-speculative engine (the Q4_0 draft of
    the float weights); ``paged``: the page pool. ``pair``: a (model,
    params) pair to serve instead of building one."""
    device = resolve_device(device)
    model, params = pair or _model(arch, device, full)
    geo = _geometry(full)
    page_size = geo.pop("page_size")
    kw = dict(paged=True, page_size=page_size) if paged else {}
    if paged and not full:
        kw.update(n_pages=N_PAGES, n_cross_pages=N_CROSS_PAGES)
    return ServeEngine(model, params, cache_dtype=cache_dtype,
                       decode_block=DECODE_BLOCK, spec_k=spec_k,
                       device=device, **geo, **kw)


def build_family_engines(cache_dtypes: tuple = ("bf16",),
                         device=None) -> list[ServeEngine]:
    """One engine per (family arch, supported cache dtype)."""
    out = []
    for arch in FAMILY_ARCHS:
        pair = _model(arch, resolve_device(device))
        for cd in cache_dtypes:
            if cd != "bf16" and not pair[0].state_spec().supports_tier(cd):
                continue
            out.append(build_engine(cd, arch, device, pair=pair))
    return out


def build_full_engines(device=None) -> tuple[list, list]:
    """whisper-tiny.en at full width and ``FULL_GEOMETRY``: (slot-pool
    engines, paged engines), each with Q8_0 weights and the q8_0 cache
    (the paper's variant) and with the float weights and the bf16
    cache."""
    device = resolve_device(device)
    model, params = _model("whisper-tiny-en", device, full=True)
    pairs = {"q8_0": (model, quantize_tree(params)), "bf16": (model, params)}
    return ([build_engine(cd, device=device, full=True, pair=pair)
             for cd, pair in pairs.items()],
            [build_engine(cd, device=device, full=True, paged=True,
                          pair=pair) for cd, pair in pairs.items()])


# ----------------------------------------------------------------------------
# programs
# ----------------------------------------------------------------------------

def _tag(eng: ServeEngine) -> str:
    """``[q8_0]`` (Whisper), ``[qwen3-4b|bf16]`` (the families),
    ``[spec2|q4_0]`` (a speculative engine)."""
    cfg = eng.model.cfg
    if eng.spec_k:
        return f"[spec{eng.spec_k}|{eng.cache_dtype}]"
    return f"[{eng.cache_dtype}]" if cfg.enc_dec \
        else f"[{cfg.name}|{eng.cache_dtype}]"


def _frames(eng: ServeEngine, s: int) -> torch.Tensor:
    rng = np.random.default_rng(SEED)
    x = rng.standard_normal((1, s, eng.model.cfg.d_model)) * 0.5
    return torch.from_numpy(x.astype(np.float32)).to(eng.device)


def _tick_program(name: str, eng: ServeEngine) -> HotProgram:
    def tick():
        with use_context(eng.dispatch_ctx):
            return eng._tick(DECODE_BLOCK)
    return program_from_fn(name, tick, eng=eng,
                           handed=lambda: engine_buffers(eng, state=True))


def _prefill_program(name: str, eng: ServeEngine) -> HotProgram:
    # recurrent lanes prefill at the exact prompt length (any length is
    # a key of its own); KV lanes at a bucket, with 4 live tokens
    n = BUCKET - 3 if eng.spec.prefill_exact else 4
    enc = {"enc_frames": _frames(eng, ENC_S)} if eng.enc_dec else {}
    batch = eng._prefill_batch(list(range(3, 3 + n)), enc)
    return program_from_fn(name, eng._prefill_device, 0, batch, n, eng=eng,
                           handed=lambda: engine_buffers(eng))


def _extend_program(name: str, eng: ServeEngine) -> HotProgram:
    with torch.no_grad(), use_context(eng.dispatch_ctx):
        states = eng.model.encode(eng._served, _frames(eng, S_NEW))
        k, v = encdec.cross_attn_kv(eng._served, eng.model.cfg, states)
    if eng.paged:
        # per-frame (page, offset) targets on the scratch page 0
        i64 = dict(dtype=torch.int64, device=eng.device)
        at = (torch.zeros(S_NEW, **i64), torch.arange(S_NEW, **i64))
    else:
        at = (0, slice(0, S_NEW))
    return program_from_fn(name, _extend_cross_cache,
                           eng.cache["layers"]["cross"], k, v, at,
                           eng.cache_dtype, eng=eng,
                           handed=lambda: engine_buffers(eng))


def frontend_program(d_model: int, device) -> HotProgram:
    """``frontend_gemm``: the frontend's projection path over 4 embedding
    frames of log-mel."""
    from repro_torch.audio.features import FrontendConfig, mel_to_frames
    fcfg = FrontendConfig()
    rng = np.random.default_rng(SEED)
    mel = torch.from_numpy(rng.standard_normal(
        (4 * fcfg.stride, fcfg.n_mels)).astype(np.float32)).to(device)
    with torch.no_grad():
        mel_to_frames(mel, d_model, fcfg)
    return program_from_fn("frontend_gemm", mel_to_frames, mel, d_model,
                           fcfg, device=device)


def hot_programs(eng: ServeEngine,
                 frontend: bool = True) -> list[HotProgram]:
    """Trace the serving hot path of one slot-pool engine. Program names
    carry the cache dtype (``decode_block[q8_0]``), the arch for the
    model-zoo engines (``decode_block[xlstm-350m|bf16]``) and ``spec``
    for a speculative engine (``decode_block[spec2|q4_0]``)."""
    tag = _tag(eng)
    programs = [_tick_program(f"decode_block{tag}", eng),
                _prefill_program(f"prefill{tag}", eng)]
    if eng.enc_dec:
        programs.append(_extend_program(f"extend_cross_cache{tag}", eng))
    if frontend:
        programs.append(frontend_program(eng.model.cfg.d_model, eng.device))
    return programs


def paged_hot_programs(eng: ServeEngine) -> list[HotProgram]:
    """Trace the paged engine's hot path: the page-table decode tick,
    the page-row prefill scatter and the streaming cross extension."""
    assert eng.paged
    tag = _tag(eng)
    return [_tick_program(f"paged_decode_block{tag}", eng),
            _prefill_program(f"paged_prefill{tag}", eng),
            _extend_program(f"paged_extend_cross{tag}", eng)]
