"""Slot-pool serving engine of the port (the JAX package's
``serving/engine.py``): the enc-dec Whisper model with bf16, q8_0 and
q4_0 caches and self-speculative decoding; decoder-only KV lanes (the
dense and MoE attention families) with the same tiers where the model's
spec allows them; and decoder-only recurrent lanes (xLSTM) with a bf16
state pool.

The engine owns a fixed pool of ``n_slots`` cache slots on the device:
stacked self/cross KV planes, stacked per-segment K/V planes with MoE
routing counters, or stacked per-segment recurrent state, as the
model's ``LaneStateSpec`` declares. Admission prefills one request, at a
bucketed token length (powers of two from 32) for KV lanes, with the
live length as ``n_valid`` so that bucket padding never takes an expert's
capacity from a live token, or at the exact prompt length for recurrent
lanes (``prefill_exact``: padding would be folded into the state),
quantizes
the prefill cache for a q8_0 or q4_0 pool, writes it into a free slot
**in place** and fetches one scalar, the first token. A decode step
writes each lane's new K/V row, or its whole new recurrent state, into
the pool in place.

Decode state lives on the device, in buffers the engine keeps for its
life and updates in place: last token, position, encoder length, the
active mask, EOS ids, ``max_new`` budgets and emitted counts. One tick
(``step``) runs ``decode_block`` decode steps over the whole pool with
per-lane positions; EOS, max_new and max_len freeze finished lanes on
the device, so a ``k``-step tick is token-identical to ``k`` single
steps. The tick makes **one** host fetch, the ``(k, n_slots)`` token
block with its emit mask (``_host_syncs`` counts them); host Python then
replays the emit mask to append tokens and free slots. An MoE step adds
each lane's executed top-k assignments to its routing counters in place;
``routing_report`` fetches them, a diagnostic outside the tick.

On a CUDA device the tick is one CUDA graph, the counterpart of the
reference's donated ``jax.jit``: the first tick of ``k`` steps runs
eagerly (it also builds the kernels and the library handles), the next
one captures the same body once, and every later tick of ``k`` steps
replays it (``captures`` / ``replays`` count them). The graph reads the
weights, the cache pool and the decode state by address, so admission
and ``_free_slot`` write them in place; it writes the token block, the
emit mask and the kept logits into its own buffers, which ``step_begin``
clones for the caller. A capture or a replay that fails raises: there is
no fallback to the eager tick. ``cuda_graph=False`` runs the eager tick
on the card, for comparison; on the CPU the tick is always eager.
The dispatch log and the kernels' launch counts are taken from the
capture pass and added once per replay (``api.replay_record``), so they
read per tick as an eager tick's. Routing is fixed at capture, as the
reference's is at trace time.

The weights a step multiplies are held in the model's serving tree
(``Model.prepare_serving``): what a step would derive from them (the
tied head's f32 operand, widened or stacked sLSTM weights, bf16
projections) is made once per engine, not at every step.

With ``spec_k > 0`` a tick runs ``decode_block // spec_k`` speculative
rounds instead: ``spec_k - 1`` greedy draft steps on quantized draft
weights, one full-model forward that verifies all ``spec_k`` positions
at once, and the acceptance of the leading draft hits, cut by the same
EOS / max_new / max_len stops. The emitted stream is token-identical to
plain greedy decode and the tick still makes one host fetch.

Streaming audio (``StreamingAudioRequest``): ``open_stream`` takes a
slot without a prefill; each ``stream_feed`` encodes one chunk of frame
embeddings (block-diagonal: its states never change as more audio
arrives); the first anchors the prompt with a prefill over those states,
every later one projects the chunk through each decoder layer's cross
K/V (``encdec.cross_attn_kv``), rounds it as the prefill does and
writes it after the lane's cached positions **in place**
(``_extend_cross_cache``), then grows the lane's encoder length with one
asynchronous copy, so the next tick, replayed or not, attends the new
audio. A lane whose mid-stream hypothesis is complete pauses, keeping
its slot; ``stream_finalize`` prefills the prompt again over all the
states, which makes the final transcript token-identical to one-shot
serving of the same chunks.

With ``paged=True`` (enc-dec only) the slot pool becomes a shared page
pool (``repro_torch.paging``): ``n_pages`` self and ``n_cross_pages``
cross pages of ``page_size`` positions, page 0 the scratch page. A lane
holds ``ceil((n + max_new) / P)`` self pages (``spec_k - 1`` more when
speculating) and ``ceil(enc_s / P)`` cross pages, not ``max_len`` /
``enc_len`` padding, and requests with the same audio, or the same audio
and full prompt pages, share pages by content (SHA-1 of the encoder
input). Admission prefills one lane densely and scatters its page rows
to the lane's pages, the scratch page taking the bucket padding; a pool
without the pages returns None, as a full slot pool does. The two page
tables' device tensors are made once and written in place by every
mapping change, so the captured tick reads them by address, as it reads
the pool. A stream's cross pages grow chunk by chunk (``extend_cross``)
before the chunk is written; running out of pages mid-stream raises
``RejectionError(POOL_EXHAUSTED)``. Decode is token- and bit-equal to
the slot pool when ``n_lp * P`` equals the slot pool's ``max_len`` /
``enc_len`` (the decode kernels' chunk plan depends on it).
"""

from __future__ import annotations

import contextlib
import dataclasses
import enum
import gc
import itertools
from typing import Any, Optional

import torch

from repro_torch.kernels import api
from repro_torch.kernels.api import (DispatchContext, dispatch_counters,
                                     dispatch_trace, use_context)
from repro_torch.kernels.q4_attention.ops import cache_traffic_ratio_q4
from repro_torch.kernels.q8_attention.ops import cache_traffic_ratio
from repro_torch.models import encdec
from repro_torch.models.attention import quantize_kv_cache
from repro_torch.models.model import Model, cache_bytes
from repro_torch.paging import PageAllocError, PagedKV, content_digest
from repro_torch.platforms import Platform, get_platform, resolve_device
from repro_torch.quantize import QTENSORS, stored_bytes
from repro_torch.serving.lanestate import LaneStatePool

EOS_DEFAULT = 2

CACHE_DTYPES = ("bf16", "q8_0", "q4_0")

QUANT_TIERS = ("q8_0", "q4_0")

_ENGINE_SEQ = itertools.count()   # unique dispatch-trace tags per engine


class RejectCode(enum.Enum):
    """Machine-readable rejection and shed reasons: the first group from
    ``ServeEngine.validate`` (the request can never be served by this
    engine), the second from the gateway's admission and lifecycle paths
    (``repro_torch.gateway``)."""

    # --- engine validation
    TOO_LONG = "too_long"                        # prompt+max_new vs max_len
    MISSING_ENC_INPUT = "missing_enc_input"      # enc-dec model, no frames
    AMBIGUOUS_ENC_INPUT = "ambiguous_enc_input"  # frames AND states given
    BAD_ENC_SHAPE = "bad_enc_shape"              # misshapen frames/states
    ENC_OVERFLOW = "enc_overflow"                # frames exceed pool enc_len
    ENC_ON_DECODER_ONLY = "enc_on_decoder_only"  # frames for a decoder-only
    POOL_EXHAUSTED = "pool_exhausted"            # paged KV pool out of pages
    #   (validate: the request's page demand exceeds the whole pool;
    #    gateway: load-shed because free pages ran low)
    # --- gateway admission / lifecycle
    QUEUE_FULL = "queue_full"                    # bounded-queue backpressure
    DEADLINE_UNMEETABLE = "deadline_unmeetable"  # shed at submit (estimate)
    DEADLINE_MISSED = "deadline_missed"          # shed at admit, pre-prefill
    CANCELLED = "cancelled"                      # aborted in flight
    TIMEOUT = "timeout"                          # client-side timeout_s hit


@dataclasses.dataclass(frozen=True)
class Rejection:
    code: RejectCode
    message: str

    def __str__(self) -> str:
        return self.message


class RejectionError(ValueError):
    """``admit`` failure carrying the structured ``Rejection``."""

    def __init__(self, rejection: Rejection):
        super().__init__(rejection.message)
        self.rejection = rejection


@dataclasses.dataclass
class Request:
    uid: int
    tokens: list             # prompt token ids
    max_new: int = 16
    eos_id: int = EOS_DEFAULT
    enc_frames: Optional[Any] = None   # (S_enc, d_model) frame embeddings
    enc_states: Optional[Any] = None   # or (S_enc, d_model) encoder states


@dataclasses.dataclass
class AudioRequest(Request):
    """A request that must carry encoder input: ``enc_frames`` (encoded
    at admit) or precomputed ``enc_states``."""

    def __post_init__(self):
        if self.enc_frames is None and self.enc_states is None:
            raise ValueError(f"AudioRequest {self.uid} requires enc_frames "
                             f"or enc_states")


@dataclasses.dataclass
class StreamingAudioRequest(Request):
    """An audio request whose encoder frames arrive incrementally:
    ``chunks``, a list of (s_i, d_model) frame-embedding chunks, fixed
    size but the tail. The scheduler feeds one chunk a tick through
    ``ServeEngine.open_stream`` / ``stream_feed``; decode ticks in
    between emit partial hypotheses (``RequestState.partials``), and
    ``stream_finalize`` re-anchors the prompt against the whole audio,
    so the final transcript is token-identical to one-shot serving."""

    chunks: Optional[list] = None

    def __post_init__(self):
        if not self.chunks:
            raise ValueError(f"StreamingAudioRequest {self.uid} requires a "
                             f"non-empty list of frame chunks")
        if self.enc_frames is not None or self.enc_states is not None:
            raise ValueError(f"StreamingAudioRequest {self.uid}: frames "
                             f"arrive via chunks, not enc_frames/enc_states")


@dataclasses.dataclass
class RequestState:
    req: Request
    slot: int
    pos: int                 # next position to write
    out: list                # generated ids
    done: bool = False
    error: Optional[str] = None
    error_code: Optional[RejectCode] = None
    # streams: one snapshot of ``out`` per fed chunk (the hypotheses
    # emitted while audio was still arriving)
    partials: list = dataclasses.field(default_factory=list)
    # with keep_logits: the (vocab,) logits row each token of ``out``
    # was chosen from, on the device (an anchor restarts both)
    logits: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class PendingTick:
    """A dispatched, not yet fetched decode tick: the device tensors of
    the ``(k, n_slots)`` token block and emit mask, with keep_logits
    the ``k`` (n_slots, vocab) logits rows the block was chosen from,
    and on a CUDA device the stream the tick was issued on."""

    k: int
    tok_blk: Any
    emit_blk: Any
    logits: list = dataclasses.field(default_factory=list)
    stream: Any = None


@dataclasses.dataclass
class _StreamState:
    """Engine-side state of one open audio stream (slot-keyed)."""

    states: list                  # encoded chunk states, each (1, s_i, d)
    n_frames: int = 0             # frames fed == valid encoder positions
    anchored: bool = False        # the prompt prefill has run once


def _bucket(n: int, buckets=(32, 64, 128, 256, 512, 1024, 2048)) -> int:
    for b in buckets:
        if n <= b:
            return b
    return -(-n // 2048) * 2048


def _first_leaf(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree.q if isinstance(tree, QTENSORS) else tree


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, QTENSORS):
        yield tree.q
        yield tree.scale
    else:
        yield tree


def _has_qtensor(tree) -> bool:
    if isinstance(tree, dict):
        return any(_has_qtensor(v) for v in tree.values())
    return isinstance(tree, QTENSORS)


def _shape(x) -> tuple:
    return tuple(x.shape) if hasattr(x, "shape") else ()


class ServeEngine:
    def __init__(self, model: Model, params: Any, *, n_slots: int = 8,
                 max_len: int = 256, enc_len: int = 64,
                 cache_dtype: str = "bf16", decode_block: int = 1,
                 platform: Optional[Any] = None,
                 dispatch_ctx: Optional[DispatchContext] = None,
                 device=None, keep_logits: bool = False,
                 paged: bool = False, page_size: int = 8,
                 n_pages: Optional[int] = None,
                 n_cross_pages: Optional[int] = None, spec_k: int = 0,
                 draft_dtype: str = "q4_0", draft_params: Any = None,
                 cuda_graph: Optional[bool] = None):
        """``device``: where the pool lives and decode runs (default
        ``cuda``; without CUDA pass ``device="cpu"``). ``params`` must
        already be on it. ``platform`` (a registered
        ``repro_torch.platforms`` name) derives the dispatch context and
        enables ``energy_report``. ``cache_dtype``: ``"bf16"``,
        ``"q8_0"`` (int8 + f16-scale planes read by the
        q8_decode_attention kernel) or ``"q4_0"`` (nibble-packed planes
        read by q4_decode_attention, ~0.28x the bf16 cache bytes).
        ``decode_block``: decode steps per tick, one host fetch per tick.
        ``spec_k`` > 0: self-speculative decoding, ``spec_k - 1`` draft
        tokens a round from ``draft_params`` (default: ``params``
        quantized to ``draft_dtype``), verified in one full-model
        forward; ``decode_block`` must be a multiple of it.
        ``keep_logits``: keep, in each ``RequestState.logits``, the
        (vocab,) logits row each of its tokens was chosen from, on the
        device. ``cuda_graph``: replay each tick from a CUDA graph (the
        default on a CUDA device) or run it eagerly (``False``; the only
        form on the CPU, where ``True`` raises). ``paged=True`` (enc-dec
        only): a shared page pool of ``n_pages`` self and
        ``n_cross_pages`` cross pages of ``page_size`` positions (the
        defaults hold the slot pool's bytes plus the scratch page); see
        the module docstring."""
        if cache_dtype not in CACHE_DTYPES:
            raise ValueError(f"cache_dtype {cache_dtype!r}: expected one "
                             f"of {CACHE_DTYPES}")
        if int(decode_block) < 1:
            raise ValueError(f"decode_block must be >= 1, got "
                             f"{decode_block}")
        self.device = resolve_device(device)
        if cuda_graph is None:
            cuda_graph = self.device.type == "cuda"
        elif cuda_graph and self.device.type != "cuda":
            raise ValueError(f"cuda_graph=True needs a CUDA device; the "
                             f"engine runs on {self.device}")
        self.cuda_graph = bool(cuda_graph)
        leaf = _first_leaf(params)
        if leaf.device != self.device:
            raise ValueError(f"params live on {leaf.device}, the engine on "
                             f"{self.device}")
        cfg = model.cfg
        self.spec = model.state_spec()
        self.enc_dec = bool(cfg.enc_dec)
        if cache_dtype in QUANT_TIERS:
            if not self.spec.self_kv and not self.spec.cross_kv:
                raise ValueError(
                    f"cache_dtype={cache_dtype!r} quantizes attention KV "
                    f"planes; {cfg.name} lanes carry only recurrent "
                    f"state ({'/'.join(self.spec.recurrent)}): serve it "
                    f"with cache_dtype='bf16'")
            if not self.spec.supports_tier(cache_dtype):
                raise ValueError(f"{cfg.name} cannot hold a {cache_dtype} "
                                 f"KV cache (head_dim={cfg.head_dim})")
        self.spec_k = int(spec_k)
        self.draft_dtype = draft_dtype
        self.draft_params = None
        if self.spec_k:
            if self.spec_k < 2:
                raise ValueError(f"spec_k must be >= 2 (1 draft + 1 "
                                 f"verify minimum), got {spec_k}")
            if draft_dtype not in QUANT_TIERS:
                raise ValueError(f"draft_dtype {draft_dtype!r}: expected "
                                 f"one of {QUANT_TIERS}")
            if not self.spec.self_kv or self.spec.recurrent:
                # a rejected draft would leave a recurrent state advanced
                # (the hybrid has self-KV beside its ssm state)
                raise ValueError(
                    f"speculative decoding rewinds self-KV write "
                    f"cursors; {cfg.name} lanes carry "
                    f"{'/'.join(self.spec.recurrent) or 'no'} recurrent "
                    f"state, which cannot be rolled back")
            if self.spec.moe_experts:
                raise ValueError(
                    f"speculative decoding does not thread the per-lane "
                    f"routing counters through draft/verify; {cfg.name} "
                    f"is MoE")
            if cfg.attn_softcap is not None or cfg.sliding_window \
                    is not None or cfg.local_global:
                raise ValueError(
                    f"speculative decoding supports plain softmax decode "
                    f"attention only; {cfg.name} uses softcap/windowed "
                    f"attention")
            if int(decode_block) % self.spec_k:
                raise ValueError(
                    f"decode_block ({decode_block}) must be a multiple "
                    f"of spec_k ({spec_k}): a tick runs decode_block // "
                    f"spec_k draft-verify rounds")
            if draft_params is not None:
                self.draft_params = draft_params
            elif _has_qtensor(params):
                raise ValueError(
                    "served params are already quantized; pass "
                    "draft_params= explicitly (the engine builds draft "
                    "weights from float params only)")
            else:
                self.draft_params = model.quantize(params, draft_dtype)
        self.paged = bool(paged)
        self.page_size = int(page_size)
        self.pages: Optional[PagedKV] = None
        self.page_tables: Optional[dict] = None
        if self.paged:
            if not self.enc_dec:
                raise ValueError(f"paged=True requires an enc-dec model; "
                                 f"{cfg.name} is decoder-only")
            if max_len % self.page_size or enc_len % self.page_size:
                raise ValueError(
                    f"max_len ({max_len}) and enc_len ({enc_len}) must be "
                    f"multiples of page_size ({self.page_size})")
        self.platform: Optional[Platform] = \
            get_platform(platform) if platform is not None else None
        if dispatch_ctx is None and self.platform is not None:
            dispatch_ctx = DispatchContext.for_platform(
                self.platform,
                tag=f"serve:{self.platform.name}#{next(_ENGINE_SEQ)}")
        self.model = model
        self.params = params
        # what decode multiplies: the weights with their derived tensors
        # made once (the draft's too); ``params`` stays as given
        self._served = model.prepare_serving(params)
        self._draft_served = None if self.draft_params is None \
            else model.prepare_serving(self.draft_params)
        self.dispatch_ctx = dispatch_ctx
        self.n_slots = n_slots
        self.max_len = max_len
        self.enc_len = enc_len
        self.cache_dtype = cache_dtype
        self.decode_block = int(decode_block)
        self.keep_logits = keep_logits
        cdt = cache_dtype if cache_dtype in QUANT_TIERS else torch.bfloat16
        if self.paged:
            # the defaults hold the slot pool's bytes, plus the scratch page
            if n_pages is None:
                n_pages = n_slots * (max_len // self.page_size) + 1
            if n_cross_pages is None:
                n_cross_pages = n_slots * (enc_len // self.page_size) + 1
            self.pages = PagedKV(n_slots=n_slots, max_len=max_len,
                                 enc_len=enc_len, page_size=self.page_size,
                                 n_pages=n_pages,
                                 n_cross_pages=n_cross_pages,
                                 device=self.device)
            self.cache = model.init_paged_cache(n_pages, n_cross_pages,
                                                self.page_size, dtype=cdt,
                                                device=self.device)
            # the tables' device tensors, which the tick reads by address
            self.page_tables = {"self": self.pages.self_table.device(),
                                "cross": self.pages.cross_table.device()}
        else:
            self.cache = model.init_cache(n_slots, max_len, enc_len,
                                          dtype=cdt, device=self.device)
        self.free = list(range(n_slots))
        self.active: dict[int, RequestState] = {}
        self._streams: dict[int, _StreamState] = {}
        self.lanestate = LaneStatePool(n_slots)
        # device-resident decode state; parked lanes decode at pos 0
        # with active=False, so their emits are masked
        i64 = dict(dtype=torch.int64, device=self.device)
        self._tokens = torch.zeros((n_slots, 1), **i64)
        self._pos = torch.zeros((n_slots,), **i64)
        self._enc_lens = torch.zeros((n_slots,), **i64)
        self._lane_active = torch.zeros((n_slots,), dtype=torch.bool,
                                        device=self.device)
        self._lane_eos = torch.zeros((n_slots,), **i64)
        self._lane_max = torch.zeros((n_slots,), **i64)
        self._lane_out = torch.zeros((n_slots,), **i64)
        # k -> (graph, its output buffers, its TickRecord); the tick
        # sizes that have run eagerly once
        self._graphs: dict[int, tuple] = {}
        self._warm: set[int] = set()
        self._capture_stream = None
        self.captures = 0
        self.replays = 0
        # serving accounting (energy_report)
        self._ticks = 0
        self._decode_steps = 0
        self._generated = 0
        self._host_syncs = 0
        self._zero_spec_stats()

    def _zero_spec_stats(self) -> None:
        self._draft_steps = 0
        self._verify_steps = 0
        self._spec_rounds = 0
        self._spec_emitted = 0      # tokens emitted by spec ticks
        self._spec_live_rounds = 0  # (round, lane) pairs that emitted

    # ------------------------------------------------------------------
    def _set_lane(self, slot: int, *, token: int, pos: int, enc_len: int,
                  eos: int, max_new: int, n_out: int,
                  active: bool) -> None:
        """Write one lane's device-resident decode state (admit / free;
        host -> device only). The values travel in one asynchronous
        copy: a Python scalar written into a CUDA tensor is a blocking
        copy each, which would wait on the device seven times a lane."""
        vals = torch.tensor([token, pos, enc_len, eos, max_new, n_out,
                             int(active)], dtype=torch.int64)
        vals = vals.to(self.device, non_blocking=True)
        self._tokens[slot, 0] = vals[0]
        self._pos[slot] = vals[1]
        self._enc_lens[slot] = vals[2]
        self._lane_eos[slot] = vals[3]
        self._lane_max[slot] = vals[4]
        self._lane_out[slot] = vals[5]
        self._lane_active[slot] = vals[6] != 0

    def _set_enc_len(self, slot: int, n: int) -> None:
        """Grow a streaming lane's encoder length in place, by the same
        single asynchronous copy as ``_set_lane``."""
        val = torch.tensor([n], dtype=torch.int64)
        self._enc_lens[slot] = val.to(self.device, non_blocking=True)[0]

    def validate(self, req: Request) -> Optional[Rejection]:
        """A ``Rejection`` if this engine can never serve ``req``, else
        None."""
        C = RejectCode
        n = len(req.tokens)
        # speculative lanes write draft/verify KV up to spec_k - 1
        # positions past the last emitted token before the stops bind:
        # that whole extent stays inside the pool
        headroom = self._headroom()
        if n + req.max_new + headroom >= self.max_len:
            return Rejection(C.TOO_LONG,
                             f"request {req.uid} too long for engine "
                             f"({n}+{req.max_new}"
                             + (f"+{headroom} speculative headroom"
                                if headroom else "")
                             + f" vs {self.max_len})")
        stream = isinstance(req, StreamingAudioRequest)
        if not self.enc_dec:
            if req.enc_frames is not None or req.enc_states is not None \
                    or stream:
                return Rejection(C.ENC_ON_DECODER_ONLY,
                                 f"request {req.uid}: encoder input on "
                                 f"decoder-only model "
                                 f"{self.model.cfg.name}")
            return None
        d_model = self.model.cfg.d_model
        if stream:
            total = 0
            for i, c in enumerate(req.chunks):
                shp = _shape(c)
                if len(shp) != 2 or shp[1] != d_model or shp[0] < 1:
                    return Rejection(C.BAD_ENC_SHAPE,
                                     f"request {req.uid}: chunk {i} must be "
                                     f"(s, {d_model}) with s >= 1, got "
                                     f"{shp}")
                total += shp[0]
            if total > self.enc_len:
                return Rejection(C.ENC_OVERFLOW,
                                 f"request {req.uid}: {total} streamed "
                                 f"encoder frames exceed the pool enc_len "
                                 f"{self.enc_len}")
            return self._fits(req, n, req.max_new + headroom, total)
        if req.enc_frames is None and req.enc_states is None:
            return Rejection(C.MISSING_ENC_INPUT,
                             f"request {req.uid}: enc-dec model "
                             f"{self.model.cfg.name} requires enc_frames "
                             f"or enc_states")
        if req.enc_frames is not None and req.enc_states is not None:
            return Rejection(C.AMBIGUOUS_ENC_INPUT,
                             f"request {req.uid}: pass enc_frames or "
                             f"enc_states, not both")
        enc = req.enc_frames if req.enc_frames is not None \
            else req.enc_states
        what = "enc_frames" if req.enc_frames is not None else "enc_states"
        shp = _shape(enc)
        if len(shp) != 2 or shp[1] != d_model:
            return Rejection(C.BAD_ENC_SHAPE,
                             f"request {req.uid}: {what} must be (S_enc, "
                             f"{d_model}), got {shp}")
        if shp[0] > self.enc_len:
            return Rejection(C.ENC_OVERFLOW,
                             f"request {req.uid}: {shp[0]} encoder "
                             f"positions exceed the pool enc_len "
                             f"{self.enc_len}")
        return self._fits(req, n, req.max_new + headroom, shp[0])

    def _fits(self, req: Request, n: int, max_new: int,
              enc_s: int) -> Optional[Rejection]:
        """POOL_EXHAUSTED for a paged engine whose whole pool could never
        hold the request's pages."""
        if self.paged and not self.pages.fits(n, max_new, enc_s):
            return Rejection(RejectCode.POOL_EXHAUSTED,
                             f"request {req.uid}: page demand exceeds the "
                             f"whole pool (can never be admitted)")
        return None

    def _headroom(self) -> int:
        """Positions a speculative lane writes past its last token."""
        return self.spec_k - 1 if self.spec_k else 0

    def _enc_tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device)[None]

    @torch.no_grad()
    def admit(self, req: Request) -> Optional[RequestState]:
        """Prefill ``req`` into a free slot; None if the pool is full.
        Raises ``RejectionError`` for a request that can never be
        served."""
        if isinstance(req, StreamingAudioRequest):
            raise ValueError(f"request {req.uid}: streaming requests are "
                             f"served via open_stream/stream_feed (or "
                             f"BatchScheduler.submit)")
        if not self.free:
            return None
        err = self.validate(req)
        if err is not None:
            raise RejectionError(err)
        n = len(req.tokens)
        slot = self.free.pop()
        if self.paged:
            from_states = req.enc_states is not None
            digest = _enc_digest(req.enc_states if from_states
                                 else req.enc_frames,
                                 "states" if from_states else "frames")
            try:
                self.pages.admit_lane(
                    slot, req.tokens, digest,
                    max_new=req.max_new + self._headroom(),
                    enc_s=int(_shape(req.enc_states if from_states
                                     else req.enc_frames)[0]))
            except PageAllocError:
                # transient: pages come back as lanes finish, and the
                # scheduler queues the request again, as for a full pool
                self.free.append(slot)
                return None
        enc, enc_s = {}, 0     # token requests on a decoder-only model
        if self.enc_dec and req.enc_states is not None:
            # precomputed states (chunked encode) skip the encoder
            enc["enc_states"] = self._enc_tensor(req.enc_states)
            enc_s = int(_shape(req.enc_states)[0])
        elif self.enc_dec:
            # encoded at the exact frame count: bidirectional attention
            # would mix bucket padding into every state
            enc["enc_frames"] = self._enc_tensor(req.enc_frames) \
                .to(torch.float32)
            enc_s = int(_shape(req.enc_frames)[0])
        first, kept = self._prefill(slot, req.tokens, enc)
        self._generated += 1
        self.lanestate.reserve(slot, self.spec, n_tokens=n + req.max_new,
                               enc_frames=enc_s)
        st = RequestState(req=req, slot=slot, pos=n, out=[first],
                          logits=kept)
        done = first == req.eos_id or len(st.out) >= req.max_new
        self._set_lane(slot, token=first, pos=n, enc_len=enc_s,
                       eos=req.eos_id, max_new=req.max_new, n_out=1,
                       active=not done)
        if done:
            st.done = True
            self._free_slot(slot)
        else:
            self.active[slot] = st
        return st

    def _prefill(self, slot: int, tokens: list, enc: dict):
        """Prefill ``tokens`` (with the encoder input ``enc``:
        ``enc_frames`` or ``enc_states``) into lane ``slot`` of the pool,
        or into its pages, in place. Returns the first token, fetched (the
        admission's one sync), and with keep_logits its logits row in a
        list."""
        first, row = self._prefill_device(
            slot, self._prefill_batch(tokens, enc), len(tokens))
        return int(first), [row] if self.keep_logits else []

    def _prefill_batch(self, tokens: list, enc: dict) -> dict:
        """The prefill's inputs on the device: the prompt at its bucket
        (one asynchronous copy) and the encoder input ``enc``."""
        n = len(tokens)
        # recurrent lanes fold every input position into the state, so
        # they prefill at the exact prompt length; KV lanes at a bucket
        bucket = n if self.spec.prefill_exact \
            else min(_bucket(n), self.max_len)
        toks = torch.zeros((1, bucket), dtype=torch.int64)
        toks[0, :n] = torch.as_tensor(tokens, dtype=torch.int64)
        batch = {"tokens": toks.to(self.device, non_blocking=True)}
        if not self.enc_dec:
            # bucket padding must not win MoE expert capacity
            batch["n_valid"] = n
        if "enc_states" in enc:
            batch["enc_states"] = enc["enc_states"].to(torch.bfloat16)
        elif "enc_frames" in enc:
            batch["enc_frames"] = enc["enc_frames"]
        return batch

    def _prefill_device(self, slot: int, batch: dict, n: int):
        """The device part of a prefill of ``n`` prompt tokens
        (``_prefill_batch``): the forward, the pool write and the first
        token's argmax, with no host sync. Returns (the first token, a
        0-d device tensor; its logits row)."""
        with use_context(self.dispatch_ctx):
            one = self.model.init_cache(1, self.max_len, self.enc_len,
                                        device=self.device)
            logits, one = self.model.forward(self._served, batch,
                                             mode="prefill", cache=one)
            if self.cache_dtype in QUANT_TIERS:
                one = quantize_kv_cache(one, self.cache_dtype)
            if self.paged:
                _scatter_pages(self.cache, one,
                               self.page_tables["self"][slot],
                               self.page_tables["cross"][slot],
                               self.page_size)
            else:
                _scatter_slot(self.cache, one, slot)
            row = logits[0, n - 1]
            return row.argmax(), row

    # ------------------------------------------------------------------
    @torch.no_grad()
    def open_stream(self, req: StreamingAudioRequest
                    ) -> Optional[RequestState]:
        """Take a slot for a streaming audio request; None if the pool is
        full. No prefill yet: the first ``stream_feed`` anchors the prompt
        against the first chunk's states."""
        if not isinstance(req, StreamingAudioRequest):
            raise ValueError(f"request {req.uid}: open_stream takes a "
                             f"StreamingAudioRequest")
        err = self.validate(req)
        if err is not None:
            raise RejectionError(err)
        if not self.free:
            return None
        slot = self.free.pop()
        if self.paged:
            # an empty lane: cross pages come a chunk at a time, self
            # pages at the first anchor
            self.pages.admit_stream_lane(slot)
        self.lanestate.reserve(slot, self.spec,
                               n_tokens=len(req.tokens) + req.max_new)
        self._streams[slot] = _StreamState(states=[])
        return RequestState(req=req, slot=slot, pos=0, out=[])

    @torch.no_grad()
    def stream_feed(self, st: RequestState, frames) -> RequestState:
        """Feed one chunk of frame embeddings ((s, d_model)) to an open
        stream: encode it, extend the slot's cross K/V in place after the
        cached positions (the first chunk anchors the prompt instead) and
        grow the lane's encoder length, so the next decode tick attends
        the new audio. Appends a partial-hypothesis snapshot to
        ``st.partials``."""
        slot = st.slot
        ss = self._streams[slot]
        fr = self._enc_tensor(frames).to(torch.float32)
        s_new = int(fr.shape[1])
        if ss.n_frames + s_new > self.enc_len:
            raise RejectionError(Rejection(
                RejectCode.ENC_OVERFLOW,
                f"request {st.req.uid}: stream overflows the pool enc_len "
                f"{self.enc_len} ({ss.n_frames}+{s_new})"))
        if self.paged:
            # the lane's cross pages cover the chunk before anything
            # writes it (the anchor's prefill or the extension)
            try:
                phys_off = self.pages.extend_cross(slot, ss.n_frames,
                                                   s_new)
            except PageAllocError as e:
                raise RejectionError(Rejection(
                    RejectCode.POOL_EXHAUSTED,
                    f"request {st.req.uid}: cross-KV page pool exhausted "
                    f"mid-stream ({e})")) from e
        with use_context(self.dispatch_ctx):
            states = self.model.encode(self._served, fr)
            if ss.anchored:
                k, v = encdec.cross_attn_kv(self._served, self.model.cfg,
                                            states)
                cross = self.cache["layers"]["cross"]
                if self.paged:
                    at = torch.tensor(phys_off).to(self.device,
                                                   non_blocking=True)
                    _extend_cross_cache(cross, k, v, (at[0], at[1]),
                                        self.cache_dtype)
                else:
                    _extend_cross_cache(
                        cross, k, v,
                        (slot, slice(ss.n_frames, ss.n_frames + s_new)),
                        self.cache_dtype)
        ss.states.append(states)
        ss.n_frames += s_new
        self.lanestate.extend_cross(slot, s_new)
        if ss.anchored:
            self._set_enc_len(slot, ss.n_frames)
        else:
            self._anchor(st, ss, final=False)
        st.partials.append(list(st.out))
        return st

    @torch.no_grad()
    def stream_finalize(self, st: RequestState) -> RequestState:
        """End of audio: anchor the prompt again against all the states
        fed (one prefill; the encoder work is not redone), so the final
        transcript is token-identical to one-shot serving of the same
        chunks. The mid-stream hypothesis stays the last entry of
        ``st.partials``."""
        slot = st.slot
        ss = self._streams.pop(slot)
        if st.out:
            st.partials.append(list(st.out))
        self.active.pop(slot, None)
        self._anchor(st, ss, final=True)
        return st

    def _anchor(self, st: RequestState, ss: _StreamState,
                final: bool) -> None:
        """The prompt prefill of a streaming lane over the states fed so
        far (the one-shot path's states prefill; it writes the slot's
        whole cross planes again, with the values the extension wrote up
        to the products' row order). Restarts ``out`` and its logits."""
        req, slot = st.req, st.slot
        n = len(req.tokens)
        if self.paged and not self.pages.lanes[slot].self_pages:
            # the first anchor: the lane's whole self extent (prompt and
            # decode budget), so no tick allocates
            try:
                self.pages.alloc_self(slot, n,
                                      req.max_new + self._headroom())
            except PageAllocError as e:
                raise RejectionError(Rejection(
                    RejectCode.POOL_EXHAUSTED,
                    f"request {req.uid}: self-KV page pool exhausted at "
                    f"anchor ({e})")) from e
        states = ss.states[0] if len(ss.states) == 1 \
            else torch.cat(ss.states, dim=1)
        first, st.logits = self._prefill(slot, req.tokens,
                                         {"enc_states": states})
        self._generated += 1
        ss.anchored = True
        st.out = [first]
        st.pos = n
        finished = first == req.eos_id or req.max_new <= 1
        self._set_lane(slot, token=first, pos=n, enc_len=ss.n_frames,
                       eos=req.eos_id, max_new=req.max_new, n_out=1,
                       active=not finished)
        if final and finished:
            st.done = True
            self._free_slot(slot)
        elif not finished:
            self.active[slot] = st
        # mid-stream and finished: the lane pauses (keeps its slot and
        # resumes at the next anchor)

    @property
    def n_streams(self) -> int:
        """Open audio streams."""
        return len(self._streams)

    @torch.no_grad()
    def encode_chunks(self, chunks) -> torch.Tensor:
        """Encode frame-embedding chunks one by one and concatenate the
        states: (1, sum(s_i), d_model)."""
        outs = []
        with use_context(self.dispatch_ctx):
            for c in chunks:
                fr = self._enc_tensor(c).to(torch.float32)
                outs.append(self.model.encode(self._served, fr))
        return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def step_begin(self, k: Optional[int] = None) -> Optional[PendingTick]:
        """Enqueue one tick of ``k`` (default ``decode_block``) decode
        steps, or of ``k // spec_k`` speculative rounds, on the device and
        return without waiting; None when no lane is active. Finished
        lanes freeze on the device. The tick replays its CUDA graph where
        the engine has one (see the module docstring); the returned
        ``PendingTick`` owns its tensors either way."""
        if not self.active:
            return None
        k = self.decode_block if k is None else int(k)
        if k < 1:
            raise ValueError(f"decode block must be >= 1, got {k}")
        if self.spec_k and k % self.spec_k:
            raise ValueError(f"decode block ({k}) must be a multiple of "
                             f"spec_k ({self.spec_k})")
        with use_context(self.dispatch_ctx):
            if self.cuda_graph and (k in self._graphs or k in self._warm):
                tok_blk, emit_blk, logits = (
                    t.clone() if t is not None else None
                    for t in self._replay(k))
            else:
                tok_blk, emit_blk, logits = self._tick(k)
                self._warm.add(k)
        stream = torch.cuda.current_stream(self.device) \
            if self.device.type == "cuda" else None
        return PendingTick(k=k, tok_blk=tok_blk, emit_blk=emit_blk,
                           logits=[] if logits is None
                           else list(logits.unbind(0)), stream=stream)

    def _tick(self, k: int):
        """The body of a tick, eager or under capture: ``k`` steps (or
        ``k // spec_k`` rounds) from the decode-state buffers, whose new
        values it copies back into them. Returns the (k, n_slots) token
        block, the emit mask and, with keep_logits, the (k, n_slots,
        vocab) logits rows (else None)."""
        state = (self._tokens, self._pos, self._lane_active,
                 self._lane_out)
        batch = {"enc_lens": self._enc_lens}
        toks, emits, rows = [], [], []
        if self.spec_k:
            for _ in range(k // self.spec_k):
                *state, o, emit, logits = self._spec_round(batch, *state)
                toks.append(o.T)
                emits.append(emit.T)
                rows.append(logits.transpose(0, 1))
        else:
            for _ in range(k):
                *state, nxt, emit, logits = self._plain_step(batch, *state)
                toks.append(nxt[None])
                emits.append(emit[None])
                rows.append(logits[None])
        # the blocks first: a plain step's emit mask is its input active
        # mask, the first step's being the buffer overwritten below
        out = (torch.cat(toks), torch.cat(emits),
               torch.cat(rows) if self.keep_logits else None)
        for buf, new in zip((self._tokens, self._pos, self._lane_active,
                             self._lane_out), state):
            buf.copy_(new)
        return out

    def _replay(self, k: int):
        """Replay the graph of a ``k``-step tick, capturing it first if
        this is its first replay; returns the graph's output buffers."""
        if k not in self._graphs:
            graph = torch.cuda.CUDAGraph()
            if self._capture_stream is None:
                self._capture_stream = torch.cuda.Stream(self.device)
            # capture on a side stream, without the device-wide
            # synchronize of ``torch.cuda.graph``: a capture runs nothing,
            # and the replay below is ordered on the current stream. The
            # cyclic garbage collector waits until the capture ends: a
            # dead engine it frees destroys its graphs, and a CUDA call
            # that is not stream-ordered invalidates the capture
            gc_on = gc.isenabled()
            gc.disable()
            try:
                with torch.cuda.stream(self._capture_stream), \
                        api.recording() as rec:
                    graph.capture_begin()
                    try:
                        out = self._tick(k)
                    finally:
                        graph.capture_end()
            finally:
                if gc_on:
                    gc.enable()
            self._graphs[k] = (graph, out, rec)
            self.captures += 1
        graph, out, rec = self._graphs[k]
        graph.replay()
        api.replay_record(rec)
        self.replays += 1
        return out

    def _stops(self, nxt, n_out, pos):
        """The on-device stop of a lane that emits ``nxt`` with ``n_out``
        tokens out and its cursor at ``pos``: EOS, max_new, max_len. The
        arguments are (B,), or (B, Q) for a round's candidates."""
        lane = (-1,) + (1,) * (nxt.dim() - 1)
        return (nxt == self._lane_eos.view(lane)) \
            | (n_out >= self._lane_max.view(lane)) \
            | (pos >= self.max_len - 1)

    def _plain_step(self, batch, tokens, pos, active, n_out):
        """One greedy decode step over the whole pool. ``forward`` writes
        the step's K/V rows or recurrent states into ``self.cache`` in
        place, so the cache it returns is the pool itself."""
        batch["tokens"] = tokens
        logits, _ = self.model.forward(self._served, batch, mode="decode",
                                       cache=self.cache, pos=pos,
                                       pages=self.page_tables)
        nxt = logits[:, -1].argmax(dim=-1)
        emit = active
        tokens = torch.where(active[:, None], nxt[:, None], tokens)
        pos = torch.where(active, pos + 1, pos)
        n_out = torch.where(active, n_out + 1, n_out)
        active = active & ~self._stops(nxt, n_out, pos)
        return tokens, pos, active, n_out, nxt, emit, logits[:, -1]

    def _spec_round(self, batch, tokens, pos, active, n_out):
        """One draft-verify round over the whole pool (the reference's
        ``_build_spec_decode``). Draft: ``spec_k - 1`` greedy steps on
        the draft weights, writing draft KV at pos .. pos + spec_k - 2.
        Verify: one full-model forward over [token, drafts] at pos ..
        pos + spec_k - 1, whose writes overwrite every draft KV entry,
        giving the true greedy continuation o_j at each position.
        Accept: o_0 .. o_{m-1}, where m - 1 counts the leading draft hits
        (d_j == o_j), cut by EOS, max_new and max_len. ``pos`` advances
        by m; a rejected tail is rolled back by not advancing it, and the
        next round writes over it before any query attends it. Returns
        the new state, o (B, spec_k), the emit mask (B, spec_k) and the
        verify logits (B, spec_k, vocab)."""
        sk, gamma = self.spec_k, self.spec_k - 1
        dtok, dpos, drafts = tokens, pos, []
        for _ in range(gamma):
            batch["tokens"] = dtok
            logits, _ = self.model.forward(self._draft_served, batch,
                                           mode="decode", cache=self.cache,
                                           pos=dpos, pages=self.page_tables)
            dtok = logits[:, -1].argmax(dim=-1)[:, None]
            dpos = dpos + 1
            drafts.append(dtok)
        drafts = torch.cat(drafts, dim=1)                      # (B, gamma)
        batch["tokens"] = torch.cat([tokens, drafts], dim=1)
        logits, _ = self.model.forward(self._served, batch, mode="decode",
                                       cache=self.cache, pos=pos,
                                       pages=self.page_tables)
        o = logits.argmax(dim=-1)                              # (B, spec_k)
        nb = tokens.shape[0]
        ones = torch.ones((nb, 1), dtype=torch.bool, device=o.device)
        match = (drafts == o[:, :gamma]).to(torch.int32)
        prefix_ok = torch.cat([ones, match.cumprod(dim=1) > 0], dim=1)
        jj = torch.arange(sk, device=o.device)[None, :]
        cand_stop = self._stops(o, n_out[:, None] + jj + 1,
                                pos[:, None] + jj + 1)
        go_on = (~cand_stop[:, :-1]).to(torch.int32).cumprod(dim=1) > 0
        emit = active[:, None] & prefix_ok & torch.cat([ones, go_on], dim=1)
        m = emit.sum(dim=1)
        last = o.gather(1, (m - 1).clamp(0, sk - 1)[:, None])
        tokens = torch.where((m > 0)[:, None], last, tokens)
        pos, n_out = pos + m, n_out + m
        active = active & ~(emit & cand_stop).any(dim=1)
        return tokens, pos, active, n_out, o, emit, logits

    def step_fetch(self, pending: PendingTick):
        """The one host sync of a tick: the ``(k, n_slots)`` token block
        and emit mask, fetched together. It may run on another thread
        than ``step_begin`` (the gateway fetches in an executor): a
        thread's current CUDA stream and device are its own, so the
        fetch runs on the tick's stream, after the tick."""
        with torch.cuda.stream(pending.stream) if pending.stream \
                is not None else contextlib.nullcontext():
            both = torch.stack([pending.tok_blk,
                                pending.emit_blk.to(torch.int64)]
                               ).cpu().numpy()
        tok_blk, emit_blk = both[0], both[1].astype(bool)
        self._host_syncs += 1
        self._ticks += 1
        emitted = int(emit_blk.sum())
        self._generated += emitted
        if self.spec_k:
            # a round is spec_k - 1 draft forwards + one verify forward
            rounds = pending.k // self.spec_k
            self._spec_rounds += rounds
            self._draft_steps += rounds * (self.spec_k - 1)
            self._verify_steps += rounds
            self._spec_emitted += emitted
            # (round, lane) pairs that emitted at all: the denominator
            # of the acceptance rate
            live = emit_blk.reshape(rounds, self.spec_k, -1).any(axis=1)
            self._spec_live_rounds += int(live.sum())
        else:
            self._decode_steps += pending.k
        return tok_blk, emit_blk

    @property
    def acceptance_rate(self) -> float:
        """Fraction of draft tokens the verify accepted so far (0.0 before
        any speculative round emitted): each live round emits one
        verified token plus the accepted drafts of its ``spec_k - 1``."""
        if not self._spec_live_rounds or self.spec_k < 2:
            return 0.0
        accepted = self._spec_emitted - self._spec_live_rounds
        return accepted / (self._spec_live_rounds * (self.spec_k - 1))

    def step_replay(self, pending: PendingTick, tok_blk,
                    emit_blk) -> list[RequestState]:
        """Host replay of a fetched tick: append emitted tokens and free
        the slots of finished requests."""
        finished = []
        for slot, st in list(self.active.items()):
            for j in range(pending.k):
                if not emit_blk[j, slot]:
                    # a speculative round that accepts m < spec_k tokens
                    # leaves a gap before the next round's rows
                    continue
                tok = int(tok_blk[j, slot])
                st.out.append(tok)
                if pending.logits:
                    st.logits.append(pending.logits[j][slot])
                st.pos += 1
                if tok == st.req.eos_id or len(st.out) >= st.req.max_new \
                        or st.pos >= self.max_len - 1:
                    self.active.pop(slot)
                    if slot in self._streams:
                        # a mid-stream hypothesis is complete: the lane
                        # pauses, keeping its slot and growing cross K/V,
                        # until stream_finalize anchors it again
                        break
                    st.done = True
                    self._free_slot(slot)
                    finished.append(st)
                    break
            if self.paged:
                # the lane's valid extent (the fragmentation report; a
                # lane freed above is gone)
                self.pages.note_len(slot, st.pos)
        return finished

    def step_end(self, pending: Optional[PendingTick]
                 ) -> list[RequestState]:
        if pending is None:
            return []
        tok_blk, emit_blk = self.step_fetch(pending)
        return self.step_replay(pending, tok_blk, emit_blk)

    def step(self, k: Optional[int] = None) -> list[RequestState]:
        """One tick over the whole pool: ``k`` decode steps on the
        device, then one host fetch. Token-identical to ``k`` calls of
        ``step(1)``."""
        return self.step_end(self.step_begin(k))

    def abort(self, st: RequestState, code: RejectCode = None,
              message: Optional[str] = None) -> None:
        """Evict an in-flight request or open stream and free its slot
        (no-op on a finished one)."""
        slot = st.slot
        if st.done or slot < 0:
            return
        self._streams.pop(slot, None)
        self.active.pop(slot, None)
        if slot not in self.free:
            self._free_slot(slot)
        st.done = True
        st.error_code = code or RejectCode.CANCELLED
        st.error = message or f"request {st.req.uid} {st.error_code.value}"

    def _free_slot(self, slot: int) -> None:
        """Return a lane to the pool and zero its decode inputs. A paged
        lane drops its page references and its table rows point at the
        scratch page again before the next tick."""
        if self.paged:
            self.pages.free_lane(slot)
        if self.lanestate.holds(slot):
            self.lanestate.release(slot)
        self.free.append(slot)
        self._set_lane(slot, token=0, pos=0, enc_len=0, eos=0, max_new=0,
                       n_out=0, active=False)

    @property
    def n_active(self) -> int:
        return len(self.active)

    # ------------------------------------------------------------------
    def cache_report(self) -> dict:
        """Cache footprint and the decode step's cache stream: every
        position of the KV pool is streamed and masked after the dot (the
        paper's LOAD term), and recurrent state is read and fully
        rewritten every step, so it streams twice a step."""
        kv_bytes, state_bytes = cache_bytes(self.cache)
        cfg = self.model.cfg
        dt = self.cache_dtype if self.cache_dtype in QUANT_TIERS else "bf16"
        per_tok = 2 * cfg.n_layers * stored_bytes(
            (cfg.n_kv_heads, cfg.head_dim), dt)
        out = {
            "cache_dtype": self.cache_dtype,
            "family": self.spec.family,
            "state_kinds": list(self.spec.state_kinds),
            "kv_bytes_total": kv_bytes,
            "state_bytes_total": state_bytes,
            "state_bytes_per_step": 2 * state_bytes,
            "bytes_per_step": kv_bytes + 2 * state_bytes,
            "self_kv_bytes_per_token": per_tok,
            "traffic_ratio_vs_bf16":
                cache_traffic_ratio() if self.cache_dtype == "q8_0"
                else cache_traffic_ratio_q4()
                if self.cache_dtype == "q4_0" else 1.0,
        }
        if self.paged:
            # a paged tick reads only mapped pages through the tables, so
            # the decode stream (and the energy model on it) prices the
            # resident pages, not n_slots x max_len of padding
            rep = self.pages.report()
            layers = self.cache["layers"]
            spb = cache_bytes(layers["self"])[0] \
                // self.pages.self_pool.n_pages
            cpb = cache_bytes(layers["cross"])[0] \
                // self.pages.cross_pool.n_pages
            resident = (rep["self"]["pages_in_use"] * spb
                        + rep["cross"]["pages_in_use"] * cpb)
            out["paging"] = {**rep, "self_page_bytes": spb,
                             "cross_page_bytes": cpb,
                             "resident_kv_bytes": resident}
            out["bytes_per_step"] = resident + 2 * state_bytes
        return out

    def paging_report(self) -> dict:
        """Page-pool occupancy, fragmentation and prefix sharing (paged
        engines only)."""
        if not self.paged:
            raise ValueError("paging_report() requires paged=True")
        return self.pages.report()

    def page_headroom(self) -> float:
        """Free-page fraction of the tighter pool (1.0 for the slot
        pool): a gateway's load-shed signal."""
        if not self.paged:
            return 1.0
        sp, cp = self.pages.self_pool, self.pages.cross_pool
        return min(sp.free_pages / max(sp.n_pages - 1, 1),
                   cp.free_pages / max(cp.n_pages - 1, 1))

    def lane_report(self) -> dict:
        return self.lanestate.report()

    def routing_report(self) -> dict:
        """MoE engines: the per-lane expert-routing counters of the
        cache's ``routing`` planes, fetched (one diagnostic sync, never on
        the tick's path). They count executed top-k assignments: a
        prefill's whole bucket, and every slot of every decode step,
        parked lanes included; the device's work, not a bill."""
        if not self.spec.moe_experts:
            raise ValueError(f"routing_report() needs an MoE model; "
                             f"{self.model.cfg.name} declares no routing "
                             f"state")
        planes = [blk["routing"] for blk in self.cache["segments"].values()
                  if "routing" in blk]
        stacked = torch.cat(planes).to(torch.int64).cpu()  # (layers, B, E)
        per_lane = stacked.sum(dim=0)
        totals = per_lane.sum(dim=0)
        return {"n_experts": self.spec.moe_experts,
                "top_k": self.spec.moe_top_k,
                "moe_layers": int(stacked.shape[0]),
                "per_lane": per_lane.tolist(),
                "per_expert": totals.tolist(),
                "executed_assignments": int(totals.sum())}

    def dispatch_report(self) -> dict:
        """Kernel-routing counters keyed (op, decision, backend),
        process-wide (reset with ``api.reset_dispatch_log``), plus the
        cache accounting."""
        return {"counters": dict(dispatch_counters()),
                "cache": self.cache_report()}

    def reset_serve_stats(self) -> None:
        """Zero the serving accounting so the next ``energy_report``
        prices only the work from here on."""
        self._ticks = 0
        self._decode_steps = 0
        self._generated = 0
        self._host_syncs = 0
        self._zero_spec_stats()

    def _param_stats(self, params=None) -> tuple[int, int]:
        """(element count, stored bytes) of the served parameters (or of
        ``params``)."""
        leaves = list(_leaves(self.params if params is None else params))
        return (sum(t.numel() for t in leaves),
                sum(t.numel() * t.element_size() for t in leaves))

    def energy_report(self, kernel: str = "fp16") -> dict:
        """Modelled joules per token on the engine's platform: decode
        steps x (weight bytes + cache bytes per step) at the platform's
        memory rate against 2 x N_params FLOP per token at its
        ``kernel``-dtype peak; latency is the larger, power the
        platform's model. A roofline model, not a measurement. With
        ``spec_k``, every draft step streams the draft weights and the
        cache once, and every verify forward streams the full weights and
        the cache once for all ``spec_k`` positions."""
        if self.platform is None:
            raise ValueError("energy_report() needs a platform: construct "
                             "the engine with ServeEngine(..., "
                             "platform='h100-sxm')")
        p = self.platform
        cache = self.cache_report()
        n_elems, weight_bytes = self._param_stats()
        steps = self._decode_steps
        tokens = self._generated
        cbs = cache["bytes_per_step"]
        cache_bytes = steps * cbs
        stream_bytes = steps * weight_bytes + cache_bytes
        flops = 2.0 * n_elems * tokens
        spec = None
        if self.spec_k:
            d_elems, d_bytes = self._param_stats(self.draft_params)
            cache_bytes += (self._draft_steps + self._verify_steps) * cbs
            stream_bytes = cache_bytes + steps * weight_bytes \
                + self._draft_steps * d_bytes \
                + self._verify_steps * weight_bytes
            flops = 2.0 * n_elems * (steps + self._verify_steps
                                     * self.spec_k) \
                + 2.0 * d_elems * self._draft_steps
            spec = {
                "spec_k": self.spec_k,
                "draft_dtype": self.draft_dtype,
                "rounds": self._spec_rounds,
                "draft_steps": self._draft_steps,
                "verify_steps": self._verify_steps,
                "acceptance_rate": self.acceptance_rate,
                "draft_weight_bytes": d_bytes,
            }
        bw = max(p.memory.main_bw, 1e-9)
        rate = p.peak_flops("q8_0" if kernel == "q8_0" else "f16")
        t_mem = stream_bytes / bw
        t_comp = flops / rate
        latency_s = max(t_mem, t_comp)
        util = t_comp / latency_s if latency_s > 0 else 0.0
        power_w = p.power.power(kernel, p.memory.local_bytes or None,
                                util=util)
        energy_j = latency_s * power_w
        tag = self.dispatch_ctx.tag if self.dispatch_ctx else None
        if tag:
            recs = [r for r in dispatch_trace() if r.tag == tag]
        else:
            recs = [r for r in dispatch_trace() if r.platform == p.name]
        accel_flops = sum(r.spec.flops for r in recs
                          if r.decision == "accel")
        trace_flops = sum(r.spec.flops for r in recs)
        return {
            "platform": p.name,
            "kernel": kernel,
            "cache_dtype": self.cache_dtype,
            "ticks": self._ticks,
            "decode_steps": steps,
            "decode_block": self.decode_block,
            "host_syncs": self._host_syncs,
            "tokens": tokens,
            "weight_bytes": weight_bytes,
            "cache_bytes_per_step": cbs,
            "stream_bytes_total": stream_bytes,
            "modeled_flops": flops,
            "memory_s": t_mem,
            "compute_s": t_comp,
            "latency_s": latency_s,
            "bound": "memory" if t_mem >= t_comp else "compute",
            "power_w": power_w,
            "pdp_j": energy_j,
            "joules_per_token": energy_j / max(tokens, 1),
            "cache_energy_j": (cache_bytes / bw) * power_w,
            "accel_flops_share":
                accel_flops / trace_flops if trace_flops else 0.0,
            "trace_records": len(recs),
            "modeled_tokens_per_s":
                tokens / latency_s if latency_s > 0 else 0.0,
            **({"speculative": spec} if spec else {}),
        }


def _extend_cross_cache(cross: dict, k: torch.Tensor, v: torch.Tensor,
                        at: tuple, tier: str) -> None:
    """Write new cross K/V positions (k, v: (L, 1, s_new, Hkv, Dh)) into
    the pool's cross planes at ``at``, in place (the captured tick reads
    the planes by address): a slot pool's (slot, slice of positions), or
    a page pool's (physical pages, offsets), s_new each. They are rounded
    as the prefill rounds its cross K/V: cast to bf16, then for a q8_0 or
    q4_0 pool (``tier``) quantized along head_dim
    (``quantize_kv_cache``)."""
    planes = {"k": k.to(torch.bfloat16), "v": v.to(torch.bfloat16)}
    if tier in QUANT_TIERS:
        planes = quantize_kv_cache(planes, tier)
    for key, val in planes.items():
        cross[key][(slice(None),) + at] = val[:, 0].to(cross[key].dtype)


def _enc_digest(x, kind: str) -> str:
    """Content key of a request's encoder input for paged prefix sharing:
    SHA-1 of its bytes with its kind (``"frames"`` / ``"states"``) mixed
    in, so the two encodings never collide. Decoder self-K/V flows
    through cross-attention, so shared prompt pages are valid only
    between lanes with the same audio: the digest keys self pages too."""
    x = torch.as_tensor(x).detach().contiguous().cpu()
    return content_digest(kind.encode(), x.view(torch.uint8).numpy().tobytes())


def _scatter_pages(pool: dict, one: dict, pv_self: torch.Tensor,
                   pv_cross: torch.Tensor, page_size: int) -> None:
    """Write a batch-1 dense cache tree into a lane's pages, in place.
    Each dense leaf (L, 1, S, .) is cut into page rows (L, S // P, P, .)
    and written at the lane's table row ``pv`` (its whole logical extent:
    mapped pages, then the scratch page, which takes the bucket padding).
    Shared pages are written again with the same bits (the prefill is
    deterministic), so the write never changes another lane's pages."""
    for kind, pv in (("self", pv_self), ("cross", pv_cross)):
        for key, plane in pool["layers"][kind].items():
            dense = one["layers"][kind][key][:, 0]
            rows = dense.reshape(dense.shape[0], -1, page_size,
                                 *dense.shape[2:])
            plane[:, pv] = rows.to(plane.dtype)


def _scatter_slot(pool: dict, one: dict, slot: int) -> None:
    """Write a batch-1 cache tree into lane ``slot`` of the pool, in
    place. Every leaf is (layers, B, ...), so the slot axis is 1."""
    for key, sub in one.items():
        if isinstance(sub, dict):
            _scatter_slot(pool[key], sub, slot)
        else:
            pool[key][:, slot] = sub[:, 0].to(pool[key].dtype)
