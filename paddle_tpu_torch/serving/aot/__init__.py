"""The AOT program store of the port (counterpart of
paddle_tpu/serving/aot.py, of a design of its own).

The reference lowers every program of the engine's plane ahead of time
through ``jax.export`` and persists the artifacts, so that an engine that
attaches the store loads its programs instead of tracing them.  A CUDA
graph cannot be saved: it holds device addresses of the process that
captured it.  So the port persists what it can, the compiled kernel
libraries its legs launch (built by ``nvcc`` at first use otherwise,
kernels/_build.py), and moves what it cannot, the captures, to attach:
``EngineCore(aot_store=...)`` captures the graph of every leg when it
attaches the store, at construction and again after a quarantine's
rebuild, before any request, where an engine without a store captures
each at the leg's first use on the request path.

Store layout (one directory)::

    <store>/
      index.json          # atomic publish point: format, version,
                          # fingerprint, widths, plane, legs, libraries
      objects/<sha>.aot   # CRC-framed objects: one descriptor a leg,
                          # one built library a kernel source

Objects carry the request journal's framing (serving/journal.py), one
``<u32 len><u32 crc32>`` frame each, named by the sha256 of the payload;
the index lands by tmp-write + fsync + ``os.replace``, so a crash
mid-build leaves unreferenced objects (``gc`` collects them), never a
half-published store.  The index carries its own ``format`` and
``version``: a store of the JAX package, or of another version, is
refused at open.

Keying: ONE fingerprint, a sha256 over the canonicalized context of
:func:`engine_aot_context` (the model config, the resolved serving
geometry, the tensor-parallel degree, the torch and CUDA versions, the
device and the key of every kernel source), and one entry a leg:
``prefill:w<width>`` for every width of ``warm_buckets()``,
``decode:<decode path>`` and, with speculation on,
``verify:<decode path>``.  A leg's descriptor names the libraries it
launched.  The port's
radix gather and scatter are eager copies, not programs, so they have
no leg.

An engine whose fingerprint differs degrades to capture at first use
(``aot_status == "skew"``, one ``aot_miss`` event); a leg that is absent
(``aot_miss``) or whose read fails (a CRC mismatch, an injected fault:
``aot_fallback``) degrades alone.  A width set that differs under a
matching fingerprint raises: the build and the engine no longer agree on the
committed widths.  The writer refuses to publish a store that misses a
leg of :data:`PLANE` or holds a plane entry that is unbounded.

Lifecycle: readers pair ``AOTStore.open`` with ``close``; writers pair
``AOTStore.create`` with ``publish`` (success) or ``discard`` (abort).
``python -m paddle_tpu_torch.serving.aot build|verify|gc`` is the
command line.
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib
import json
import os
import struct
import time
import zlib
from typing import Any, Dict, List, Sequence, Tuple

import torch

from ...kernels import _build

__all__ = ["AOTStore", "AOTStoreWriter", "AOTStoreError",
           "build_engine_store", "engine_aot_context", "aot_fingerprint",
           "engine_legs", "PLANE"]

STORE_FORMAT = "paddle_tpu_torch.aot"
STORE_VERSION = 1
INDEX_NAME = "index.json"
OBJECTS_DIR = "objects"

# the engine's step programs: each is captured as one CUDA graph per key,
# and each key space is bounded (the port's own constant; the reference
# derives its plane from a static analysis of the source)
PLANE: Dict[str, Dict[str, Any]] = {
    "prefill": {"key_space": "bounded",
                "upper_bound": "len(warm_buckets())",
                "programs": ["EngineCore._prefill_body"]},
    "decode": {"key_space": "bounded", "upper_bound": 1,
               "programs": ["EngineCore._decode_body"]},
    "verify": {"key_space": "bounded", "upper_bound": 1,
               "programs": ["EngineCore._verify_body"]},
}

# the journal's framing: (payload_len, crc32(payload)); the length guard
# rejects a garbage header before a huge allocation
_HEADER = struct.Struct("<II")
_MAX_PAYLOAD = 1 << 30


class AOTStoreError(RuntimeError):
    """A store-contract violation: an unpublished, foreign or corrupt
    store, a leg missing at publish, or build/runtime width drift."""


# --------------------------------------------------------------- keying
def _canon(obj: Any) -> Any:
    """Canonical JSON-safe form: dicts sort, tuples become lists, and
    anything non-primitive (dtypes, enums) stringifies: the fingerprint
    must not depend on dict order or repr jitter."""
    if isinstance(obj, dict):
        return {str(k): _canon(obj[k]) for k in sorted(obj, key=str)}
    if isinstance(obj, (list, tuple)):
        return [_canon(v) for v in obj]
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    return str(obj)


def aot_fingerprint(context: Dict[str, Any]) -> str:
    """Deterministic store key: sha256 over the canonicalized context
    (the reference's, so the same dict gives the same key)."""
    blob = json.dumps(_canon(context), sort_keys=True,
                      separators=(",", ":"))
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()


def _device_context(device) -> str:
    """The card's name and compute capability (``"cpu"`` off the card)."""
    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    major, minor = torch.cuda.get_device_capability(index)
    return f"{torch.cuda.get_device_name(index)} sm_{major}{minor}"


def kernel_sources() -> Tuple[str, ...]:
    """The name of every kernel source, ``csrc/<name>.cu``."""
    return tuple(sorted(p.stem for p in _build._CSRC.glob("*.cu")))


def engine_aot_context(core) -> Dict[str, Any]:
    """The fingerprint preimage for one engine: everything that shapes a
    leg's graph or the libraries it launches.  The reference's keys (the
    model config, the RESOLVED serving geometry, the tensor-parallel
    degree, the resolved speculative window) without its ``jax`` /
    ``jaxlib`` versions, plus the torch and CUDA versions, the device and
    the key of every kernel source.  The decode path is not here: it keys
    the leg (``decode:<path>``), so a fused and an unfused engine share a
    fingerprint."""
    cfg = core.model.cfg
    model_ctx = dataclasses.asdict(cfg) if dataclasses.is_dataclass(cfg) \
        else dict(vars(cfg))
    bp = core.block_pool
    return {
        "store_version": STORE_VERSION,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "device": _device_context(core.device),
        "libraries": {name: _build.library_key(name)
                      for name in kernel_sources()},
        "model_class": type(core.model).__name__,
        "model": model_ctx,
        "num_slots": core.num_slots,
        "max_seq": core.pool.max_seq,
        "min_bucket": core.scheduler.min_bucket,
        "prefill_chunk": core.prefill_chunk,
        "block_len": bp.block_len if bp is not None else None,
        "num_blocks": bp.num_blocks if bp is not None else None,
        "tensor_parallel": core.tensor_parallel,
        # the resolved speculative window (0 when speculation was not
        # requested or is not viable): it shapes the verify leg's buffers
        "spec_k": core.spec_k if core.spec_on else 0,
    }


def engine_legs(core) -> Tuple[str, ...]:
    """The legs of ``core``'s plane, in attach order: one prefill leg a
    committed width, the widest first, then the decode leg at the
    resolved path and, with speculation on, the verify leg.  Widest first
    because every graph keeps its temporaries in the engine's one pool:
    each narrower capture then fits in blocks a wider one freed, where in
    the other order every capture outgrows them and the pool grows by
    nearly the sum of all captures."""
    legs = [f"prefill:w{w}" for w in sorted(core._warm_buckets,
                                             reverse=True)]
    legs.append(f"decode:{core.decode_path}")
    if core.spec_on:
        legs.append(f"verify:{core.decode_path}")
    return tuple(legs)


def _launch_counts() -> Dict[Tuple[str, str], int]:
    """Every kernel wrapper's launch count, keyed by (library, wrapper):
    a wrapper lives in the module named after its source,
    ``kernels/<name>.py`` for ``csrc/<name>.cu``."""
    out = {}
    for lib in kernel_sources():
        mod = importlib.import_module(f"paddle_tpu_torch.kernels.{lib}")
        for fn in vars(mod).values():
            n = getattr(fn, "launches", None)
            if callable(fn) and isinstance(n, int) \
                    and getattr(fn, "__module__", None) == mod.__name__:
                out[(lib, fn.__name__)] = n
    return out


def _frame(payload: bytes) -> bytes:
    return _HEADER.pack(len(payload), zlib.crc32(payload)) + payload


def _unframe(raw: bytes, what: str) -> Tuple[bytes, int]:
    """The payload of one framed object and its crc32, or
    :class:`AOTStoreError` when the frame is short, long or fails its
    CRC."""
    if len(raw) < _HEADER.size:
        raise AOTStoreError(f"{what} truncated ({len(raw)} bytes)")
    n, crc = _HEADER.unpack_from(raw)
    if n > _MAX_PAYLOAD or len(raw) != _HEADER.size + n:
        raise AOTStoreError(
            f"{what} corrupt: framed length {n}, file holds "
            f"{len(raw) - _HEADER.size} payload bytes")
    payload = raw[_HEADER.size:]
    if zlib.crc32(payload) != crc:
        raise AOTStoreError(f"{what} corrupt: CRC mismatch")
    return payload, crc


def _atomic_write(path: str, data: bytes) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


# ---------------------------------------------------------------- store
class AOTStore:
    """Reader handle over a PUBLISHED store directory: host state and
    lazy object reads, shareable across engines.  Pair ``open`` with
    ``close``.  ``faults`` is the chaos hook: ``aot_store_corrupt`` fires
    once a leg read, on the path a CRC mismatch takes."""

    def __init__(self, path: str, index: Dict[str, Any], faults=None):
        self.path = path
        self._index = index
        self.faults = faults
        self._closed = False

    # ------------------------------------------------------- lifecycle
    @classmethod
    def open(cls, path: str, faults=None) -> "AOTStore":
        """Open a published store.  Raises :class:`AOTStoreError` when no
        index was ever published (a build that crashed before publish
        leaves none), or when the index is not this package's format and
        version (a JAX-package store among them)."""
        index_path = os.path.join(path, INDEX_NAME)
        if not os.path.exists(index_path):
            raise AOTStoreError(
                f"no published AOT store at {path!r} (missing "
                f"{INDEX_NAME}; a build that crashed before publish "
                f"leaves no index)")
        try:
            with open(index_path, "r", encoding="utf-8") as f:
                index = json.load(f)
        except (OSError, ValueError) as e:
            raise AOTStoreError(
                f"unreadable AOT store index at {index_path!r}: "
                f"{e!r}") from e
        if index.get("format") != STORE_FORMAT \
                or index.get("version") != STORE_VERSION:
            raise AOTStoreError(
                f"not a {STORE_FORMAT} store of version {STORE_VERSION}: "
                f"index format {index.get('format')!r}, version "
                f"{index.get('version')!r} (a store of the JAX package "
                f"holds jax.export artifacts, which this package cannot "
                f"run)")
        return cls(path, index, faults=faults)

    def close(self) -> None:
        """Release the handle (idempotent; reads after close raise)."""
        self._closed = True

    # --------------------------------------------------------- queries
    @property
    def fingerprint(self) -> str:
        return self._index.get("fingerprint", "")

    @property
    def widths(self) -> Tuple[int, ...]:
        """The committed prefill widths recorded at build."""
        return tuple(self._index.get("widths", ()))

    @property
    def context(self) -> Dict[str, Any]:
        return dict(self._index.get("context", {}))

    @property
    def build_seconds(self) -> float:
        """The build's seconds over every leg (the ``aot.build_s``
        gauge an attaching engine publishes)."""
        return float(sum(e.get("build_s", 0.0)
                         for e in self._index.get("programs", {}).values()))

    def programs(self) -> Dict[str, Dict[str, Any]]:
        return dict(self._index.get("programs", {}))

    def libraries(self) -> Dict[str, Dict[str, Any]]:
        return dict(self._index.get("libraries", {}))

    def has(self, name: str) -> bool:
        return name in self._index.get("programs", {})

    def nbytes(self) -> int:
        """Bytes of the objects the index references."""
        objs = {e["object"]: e["bytes"] for e in
                (*self.programs().values(), *self.libraries().values())}
        return sum(objs.values())

    # ----------------------------------------------------------- reads
    def read_leg(self, name: str
                 ) -> Tuple[Dict[str, Any], Dict[str, Tuple[bytes, int]]]:
        """One leg, CRC-checked: its descriptor and, per library it
        launched, ``(payload, crc32)``.  Raises :class:`AOTStoreError` on
        a missing entry or a corrupt object; the engine turns that into
        an ``aot_fallback`` for this leg."""
        if self._closed:
            raise AOTStoreError("AOT store handle is closed")
        entry = self._index.get("programs", {}).get(name)
        if entry is None:
            raise AOTStoreError(
                f"leg {name!r} not in store index (have: "
                f"{sorted(self._index.get('programs', {}))})")
        if self.faults is not None \
                and self.faults.check("aot_store_corrupt") is not None:
            raise AOTStoreError(f"leg {name!r} corrupt (injected)")
        payload, _ = self._read_object(entry["object"], f"leg {name!r}")
        try:
            desc = json.loads(payload)
        except ValueError as e:
            raise AOTStoreError(f"leg {name!r}: descriptor is not JSON: "
                                f"{e!r}") from e
        if desc.get("leg") != name:
            raise AOTStoreError(f"leg {name!r}: descriptor names leg "
                                f"{desc.get('leg')!r}")
        libs = {}
        for lib in desc.get("libraries", {}):
            lentry = self._index.get("libraries", {}).get(lib)
            if lentry is None:
                raise AOTStoreError(f"leg {name!r}: library {lib!r} not "
                                    f"in store index")
            libs[lib] = self._read_object(
                lentry["object"], f"library {lib!r} of leg {name!r}")
        return desc, libs

    def _read_object(self, obj: str, what: str) -> Tuple[bytes, int]:
        path = os.path.join(self.path, OBJECTS_DIR, obj + ".aot")
        try:
            with open(path, "rb") as f:
                raw = f.read()
        except OSError as e:
            raise AOTStoreError(f"{what}: object {obj[:12]} unreadable: "
                                f"{e!r}") from e
        return _unframe(raw, f"{what}: object {obj[:12]}")

    # ------------------------------------------------------- authoring
    @classmethod
    def create(cls, path: str, *, context: Dict[str, Any],
               plane: Dict[str, Any],
               widths: Sequence[int]) -> "AOTStoreWriter":
        """Start a build into ``path``.  Pair with ``publish()`` on
        success or ``discard()`` on every abort path: nothing is visible
        to readers until publish."""
        return AOTStoreWriter(path, context=context, plane=plane,
                              widths=widths)


class AOTStoreWriter:
    """One build in flight: content-addressed objects land at once (a
    crash leaves only unreferenced objects), the index lands whole at
    :meth:`publish`."""

    def __init__(self, path: str, *, context: Dict[str, Any],
                 plane: Dict[str, Any], widths: Sequence[int]):
        self.path = path
        self.context = _canon(context)
        self.fingerprint = aot_fingerprint(context)
        self.plane = plane
        self.widths = tuple(int(w) for w in widths)
        self._programs: Dict[str, Dict[str, Any]] = {}
        self._libraries: Dict[str, Dict[str, Any]] = {}
        self._written: List[str] = []
        self._done = False
        os.makedirs(os.path.join(path, OBJECTS_DIR), exist_ok=True)

    def _object(self, payload: bytes) -> str:
        """Write one framed object (skipped when the store already holds
        it: the name is the payload's sha256).  Returns its name."""
        obj = hashlib.sha256(payload).hexdigest()
        obj_path = os.path.join(self.path, OBJECTS_DIR, obj + ".aot")
        if not os.path.exists(obj_path):
            _atomic_write(obj_path, _frame(payload))
            self._written.append(obj_path)
        return obj

    def add_library(self, name: str, payload: bytes) -> None:
        """Store the built library of ``csrc/<name>.cu`` (once)."""
        if self._done:
            raise AOTStoreError("writer already published/discarded")
        if name in self._libraries:
            return
        self._libraries[name] = {
            "key": _build.library_key(name),
            "object": self._object(payload),
            "bytes": len(payload),
            "crc32": zlib.crc32(payload),
        }

    def add(self, name: str, *, libraries: Sequence[str] = (),
            build_s: float = 0.0) -> None:
        """Store leg ``name`` (``prefill:w<width>`` / ``decode:<path>`` /
        ``verify:<path>``): its descriptor, naming the libraries it
        launched (each added first with :meth:`add_library`)."""
        if self._done:
            raise AOTStoreError("writer already published/discarded")
        missing = [lib for lib in libraries if lib not in self._libraries]
        if missing:
            raise AOTStoreError(f"leg {name!r} names libraries {missing} "
                                f"that the store does not hold")
        desc = {"leg": name, "libraries": sorted(libraries)}
        payload = json.dumps(desc, sort_keys=True,
                             separators=(",", ":")).encode()
        counter = name.split(":", 1)[0]
        self._programs[name] = {
            "object": self._object(payload),
            "bytes": len(payload),
            "counter": counter,
            "manifest_programs": list(
                self.plane.get(counter, {}).get("programs", [])),
            "libraries": sorted(libraries),
            "build_s": round(float(build_s), 6),
        }

    def _missing(self) -> List[str]:
        """Legs of the plane the build has not covered: publish refuses
        while this is non-empty."""
        return _missing(self.plane, self.widths, self._programs,
                        self.context.get("spec_k"))

    def publish(self) -> Dict[str, Any]:
        """Check the build against the plane, then publish atomically.
        Refuses (the store stays unpublished) when a leg is missing or a
        plane entry is unbounded: an unbounded key space cannot be
        enumerated ahead of time."""
        if self._done:
            raise AOTStoreError("writer already published/discarded")
        for counter, entry in sorted(self.plane.items()):
            if entry.get("key_space") == "unbounded":
                raise AOTStoreError(
                    f"refusing to publish: the plane classifies "
                    f"{counter!r} UNBOUNDED ({entry.get('programs')}); an "
                    f"unbounded program set cannot be enumerated ahead "
                    f"of time")
        missing = self._missing()
        if missing:
            raise AOTStoreError(
                f"refusing to publish: store misses legs {missing} "
                f"(plane counters: {sorted(self.plane)}, committed "
                f"widths: {list(self.widths)})")
        index = {
            "format": STORE_FORMAT,
            "version": STORE_VERSION,
            "fingerprint": self.fingerprint,
            "context": self.context,
            "widths": list(self.widths),
            "plane": {c: {"upper_bound": e.get("upper_bound"),
                          "key_space": e.get("key_space"),
                          "programs": list(e.get("programs", []))}
                      for c, e in sorted(self.plane.items())},
            "programs": self._programs,
            "libraries": self._libraries,
            "built_unix": round(time.time(), 3),
        }
        _atomic_write(os.path.join(self.path, INDEX_NAME),
                      json.dumps(index, indent=1, sort_keys=True).encode())
        self._done = True
        return index

    def discard(self) -> None:
        """Abort: drop every object this writer wrote (idempotent).  A
        previously published index, and the objects it references that
        this writer found in place, stay."""
        self._done = True
        for p in self._written:
            try:
                os.remove(p)
            except OSError:
                pass
        self._written = []


def _missing(plane: Dict[str, Any], widths: Sequence[int],
             programs: Dict[str, Any], spec_k) -> List[str]:
    """The plane's legs that ``programs`` does not cover: every committed
    width's prefill, a decode leg and, when the store's resolved
    ``spec_k`` is not 0, a verify leg."""
    covered = {e["counter"] for e in programs.values()}
    missing: List[str] = []
    for counter in sorted(plane):
        if counter == "prefill":
            missing += [f"prefill:w{w}" for w in widths
                        if f"prefill:w{w}" not in programs]
        elif counter == "verify" and not spec_k:
            continue
        elif counter not in covered:
            missing.append(f"{counter}:<path>")
    return missing


# ---------------------------------------------------------------- build
def build_engine_store(path: str, core) -> Dict[str, Any]:
    """Build and publish an AOT store of :data:`PLANE` for ``core``'s
    configuration.

    ``core`` is a constructed :class:`~paddle_tpu_torch.serving.engine.
    EngineCore` with no store attached.  On a card every leg runs once on
    it (an eager run of the body, then its capture where the engine
    captures graphs; a mesh over several cards captures none): this checks
    the leg and times it as ``build_s``.  The libraries each leg launched
    are read from the kernel build directory and each is stored once;
    with graphs, the engine then holds every leg's graph.  Off the card
    the store holds the legs' descriptors and no library.  Returns the
    published index."""
    if core.aot_store is not None:
        raise AOTStoreError("the build engine has a store attached; "
                            "build on an engine without one")
    writer = AOTStore.create(path, context=engine_aot_context(core),
                             plane=PLANE, widths=sorted(core._warm_buckets))
    try:
        on_card = torch.device(core.device).type == "cuda"
        for leg in engine_legs(core):
            t0 = time.perf_counter()
            libs: List[str] = []
            if on_card:
                before = _launch_counts()
                core._run_leg(leg, capture=core.decode_graph_reason is None)
                after = _launch_counts()
                libs = sorted({lib for (lib, fn), n in after.items()
                               if n > before.get((lib, fn), 0)})
                for lib in libs:
                    if lib not in _build._loaded:
                        raise AOTStoreError(
                            f"leg {leg!r} launched {lib!r}, which the "
                            f"process has not loaded")
                    writer.add_library(
                        lib, _build._library_path(lib).read_bytes())
            writer.add(leg, libraries=libs,
                       build_s=time.perf_counter() - t0)
        if on_card:
            core._reset_plane_state()
        return writer.publish()
    except BaseException:
        writer.discard()
        raise
