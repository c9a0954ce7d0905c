"""The PyTorch port imports neither JAX nor the JAX package.

Runs in a fresh interpreter: import ``paddle_tpu_torch`` and every one
of its submodules, then assert that no ``jax*`` and no ``paddle_tpu`` /
``paddle_tpu.*`` module was loaded.  Every import statement of the port
and of ``chip_smoke.py``, those inside functions included, is read too.
"""

import ast
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, json, pkgutil, sys
import paddle_tpu_torch
names = ["paddle_tpu_torch"]
for m in pkgutil.walk_packages(paddle_tpu_torch.__path__,
                               "paddle_tpu_torch."):
    importlib.import_module(m.name)
    names.append(m.name)
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "paddle_tpu"))
print(json.dumps({"imported": names, "bad": bad}))
"""


def test_port_imports_no_jax_and_no_reference_package(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == [], res["bad"]
    for mod in ("paddle_tpu_torch.serving.api",
                "paddle_tpu_torch.serving.engine",
                "paddle_tpu_torch.models.gpt",
                "paddle_tpu_torch.kernels.decode_attention",
                "paddle_tpu_torch.kernels.decode_block",
                "paddle_tpu_torch.kernels.flash_attention",
                "paddle_tpu_torch.kernels.fused_adamw",
                "paddle_tpu_torch.kernels.fused_norm",
                "paddle_tpu_torch.models.llama",
                "paddle_tpu_torch.incubate.nn.functional",
                "paddle_tpu_torch.nn.functional.attention",
                "paddle_tpu_torch.optimizer.optimizer",
                "paddle_tpu_torch.optimizer.adam",
                "paddle_tpu_torch.models.trainer",
                "paddle_tpu_torch.obs.tracing",
                "paddle_tpu_torch.distributed.mesh",
                "paddle_tpu_torch.serving.tp",
                "paddle_tpu_torch.serving.spec",
                "paddle_tpu_torch.kernels.collective_matmul",
                "paddle_tpu_torch.kernels.decode_block_tp",
                "paddle_tpu_torch.serving.journal",
                "paddle_tpu_torch.serving.aot",
                "paddle_tpu_torch.serving.aot.__main__",
                "paddle_tpu_torch.serving.router",
                "paddle_tpu_torch.serving.fleet",
                "paddle_tpu_torch.serving.handoff",
                "paddle_tpu_torch.serving.autoscaler",
                "paddle_tpu_torch.distributed.topology",
                "paddle_tpu_torch.distributed.strategy",
                "paddle_tpu_torch.distributed.fleet",
                "paddle_tpu_torch.distributed.sharding_utils",
                "paddle_tpu_torch.distributed.pipelining",
                "paddle_tpu_torch.distributed.meta_parallel.mp_layers",
                "paddle_tpu_torch.optimizer.sgd",
                "paddle_tpu_torch.optimizer.clip",
                "paddle_tpu_torch.optimizer.lr",
                "paddle_tpu_torch.distributed.recompute",
                "paddle_tpu_torch.distributed.fleet_utils",
                "paddle_tpu_torch.distributed.checkpoint",
                "paddle_tpu_torch.distributed.checkpoint.metadata",
                "paddle_tpu_torch.distributed.checkpoint.save_state_dict",
                "paddle_tpu_torch.distributed.checkpoint.load_state_dict",
                "paddle_tpu_torch.distributed.meta_parallel."
                "sequence_parallel",
                "paddle_tpu_torch.examples.train_gpt_hybrid",
                "paddle_tpu_torch.profiler",
                "paddle_tpu_torch.profiler.profiler",
                "paddle_tpu_torch.distributed.auto_parallel",
                "paddle_tpu_torch.distributed.auto_parallel.placement",
                "paddle_tpu_torch.distributed.auto_parallel.spmd_rules",
                "paddle_tpu_torch.distributed.auto_parallel.strategy",
                "paddle_tpu_torch.distributed.auto_parallel.api",
                "paddle_tpu_torch.distributed.auto_parallel.engine",
                "paddle_tpu_torch.framework",
                "paddle_tpu_torch.framework.io",
                "paddle_tpu_torch.metric",
                "paddle_tpu_torch.examples.train_llama_semi_auto",
                "paddle_tpu_torch.distributed.moe",
                "paddle_tpu_torch.models.gpt_moe",
                "paddle_tpu_torch.incubate.distributed",
                "paddle_tpu_torch.incubate.distributed.models",
                "paddle_tpu_torch.incubate.distributed.models.moe",
                "paddle_tpu_torch.examples.train_moe_ep",
                "paddle_tpu_torch.nn.functional.common",
                "paddle_tpu_torch.nn.functional.loss",
                "paddle_tpu_torch.nn.layers.loss",
                "paddle_tpu_torch.nn.layers.transformer"):
        assert mod in res["imported"]


def test_no_import_statement_names_jax_or_the_reference():
    """Imports a phase or a function makes when it runs are held to the
    same rule as the module-level ones: the port and ``chip_smoke.py``
    name no ``jax*`` and no ``paddle_tpu`` / ``paddle_tpu.*`` module."""
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, dirs, names in os.walk(os.path.join(REPO, "paddle_tpu_torch")):
        dirs[:] = [d for d in dirs if d != "_build"]      # build outputs
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    bad = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            bad += [(path, node.lineno, n) for n in names
                    if n.split(".")[0] in ("jax", "jaxlib", "paddle_tpu")]
    assert len(files) > 60
    assert bad == []
