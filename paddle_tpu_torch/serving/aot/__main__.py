"""Build, verify and garbage-collect an AOT store of the port
(serving/aot; the counterpart of the reference's ``scripts/aot_build.py``,
with the same subcommands and exit codes).

Usage:
    python -m paddle_tpu_torch.serving.aot build  <store>
        [--model gpt_tiny] [--device cuda] [--num-slots 4] [--max-seq 64]
        [--min-bucket 8] [--prefill-chunk 16] [--block-len 16]
        [--tensor-parallel 1] [--fused-decode] [--spec-k 0] [--seed 0]
    python -m paddle_tpu_torch.serving.aot verify <store>
    python -m paddle_tpu_torch.serving.aot gc     <store>

``build`` constructs the engine at the given shape, captures every leg of
the plane on it (on a card) and publishes the store with the kernel
libraries the captures launched.  ``verify`` exits 1 unless the store
covers every leg of the plane for its committed widths, every object
passes its CRC check and every library matches this checkout's kernel
sources.  ``gc`` removes the objects no index references (left by builds
that crashed before publish).

Exit code 0 iff the subcommand fully succeeded.
"""

import argparse
import os
import sys

from . import (OBJECTS_DIR, PLANE, AOTStore, AOTStoreError,
               _missing, build_engine_store)
from ...kernels import _build

MODELS = ("gpt_tiny", "gpt_small", "gpt3_6_7b", "llama_tiny", "llama_7b")


def _build_engine(ns):
    """The build engine at the requested shape, on a model with random
    weights from ``--seed`` (the store holds no weights)."""
    import torch

    from ... import models
    from ..engine import EngineCore

    cfg = getattr(models, ns.model)()
    cls = models.LlamaForCausalLM if ns.model.startswith("llama") \
        else models.GPTForCausalLM
    gen = torch.Generator(device=ns.device)
    gen.manual_seed(ns.seed)
    model = cls(cfg, device=ns.device, generator=gen).eval()
    tp_kw = {} if ns.tensor_parallel == 1 else dict(
        devices=[ns.device] * ns.tensor_parallel)
    return EngineCore(model, num_slots=ns.num_slots, max_seq=ns.max_seq,
                      min_bucket=ns.min_bucket,
                      prefill_chunk=ns.prefill_chunk,
                      block_len=ns.block_len,
                      tensor_parallel=ns.tensor_parallel,
                      fused_decode=ns.fused_decode,
                      spec_k=ns.spec_k, **tp_kw)


def _cmd_build(ns):
    core = _build_engine(ns)
    try:
        index = build_engine_store(ns.store, core)
    finally:
        core.close()
    progs, libs = index["programs"], index["libraries"]
    build_s = sum(e["build_s"] for e in progs.values())
    nbytes = sum(e["bytes"] for e in libs.values())
    print(f"published {len(progs)} legs and {len(libs)} libraries "
          f"({nbytes / 1e6:.1f} MB, {build_s:.1f}s build) -> {ns.store}")
    print(f"fingerprint {index['fingerprint'][:16]}... "
          f"widths {index['widths']}")
    for name in sorted(libs):
        print(f"  {name:<18} {libs[name]['bytes']:>10} B")
    return 0


def _cmd_verify(ns):
    try:
        store = AOTStore.open(ns.store)
    except AOTStoreError as e:
        print(f"verify FAILED: {e}")
        return 1
    try:
        for counter, entry in sorted(PLANE.items()):
            if entry.get("key_space") == "unbounded":
                print(f"verify FAILED: the plane classifies {counter!r} "
                      f"UNBOUNDED; the store cannot cover it")
                return 1
        missing = _missing(PLANE, store.widths, store.programs(),
                           store.context.get("spec_k"))
        if missing:
            print(f"verify FAILED: store misses legs {missing}")
            return 1
        bad = []
        for name in sorted(store.programs()):
            try:
                store.read_leg(name)      # every frame's CRC checked
            except AOTStoreError as e:
                bad.append(f"{name}: {e}")
        for lib, entry in sorted(store.libraries().items()):
            if entry["key"] != _build.library_key(lib):
                bad.append(f"library {lib}: built from sources keyed "
                           f"{entry['key']}, this checkout's key "
                           f"{_build.library_key(lib)}")
        if bad:
            print("verify FAILED: corrupt or stale objects:")
            for line in bad:
                print(f"  {line}")
            return 1
        print(f"verify OK: {len(store.programs())} legs cover the "
              f"engine plane (widths {list(store.widths)}, "
              f"{len(store.libraries())} libraries, fingerprint "
              f"{store.fingerprint[:16]}...)")
        return 0
    finally:
        store.close()


def _cmd_gc(ns):
    store = AOTStore.open(ns.store)
    try:
        live = {e["object"] + ".aot" for e in
                (*store.programs().values(), *store.libraries().values())}
    finally:
        store.close()
    obj_dir = os.path.join(ns.store, OBJECTS_DIR)
    removed = 0
    for fname in sorted(os.listdir(obj_dir)):
        if fname.endswith(".aot") and fname not in live:
            os.remove(os.path.join(obj_dir, fname))
            removed += 1
    print(f"gc: removed {removed} unreferenced objects "
          f"({len(live)} live)")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.serving.aot",
        description="build/verify/gc the serving AOT store")
    sub = ap.add_subparsers(dest="cmd", required=True)

    b = sub.add_parser("build", help="build + publish a store")
    b.add_argument("store", help="store directory")
    b.add_argument("--model", choices=MODELS, default="gpt_tiny")
    b.add_argument("--device", default="cuda",
                   help="the engine's device (cpu: no capture, no "
                        "library)")
    b.add_argument("--num-slots", type=int, default=4)
    b.add_argument("--max-seq", type=int, default=64)
    b.add_argument("--min-bucket", type=int, default=8)
    b.add_argument("--prefill-chunk", type=int, default=16)
    b.add_argument("--block-len", type=int, default=16)
    b.add_argument("--tensor-parallel", type=int, default=1)
    b.add_argument("--fused-decode", action="store_true")
    b.add_argument("--spec-k", type=int, default=0,
                   help="speculative draft length; > 0 adds the verify "
                        "leg")
    b.add_argument("--seed", type=int, default=0)
    b.set_defaults(fn=_cmd_build)

    v = sub.add_parser("verify",
                       help="exit 1 unless the store covers the plane "
                            "and every object is sound")
    v.add_argument("store", help="store directory")
    v.set_defaults(fn=_cmd_verify)

    g = sub.add_parser("gc", help="remove unreferenced objects")
    g.add_argument("store", help="store directory")
    g.set_defaults(fn=_cmd_gc)

    ns = ap.parse_args(argv)
    return ns.fn(ns)


if __name__ == "__main__":
    sys.exit(main())
