"""Remat and sequence parallelism through the kernels on the card (``-m
cuda``; no JAX import).

An f32 model of 256 width with 64-wide heads (TF32 off):

* the serial trainer with ``remat=True`` launches each block's flash
  forward and LayerNorm forwards twice a step (the backward replays the
  block) and the backward kernels once, with ``remat=False``'s loss;
* ``{mp 2, pp 2}`` with ``sp=True`` normalises each block's ``b·s/mp``
  rows a rank (``ln_f`` the gathered ``b·s``) and gives the serial
  trainer's losses at the reference oracle's bounds.

With no CUDA device the example script raises and names ``--device``.
"""

import dataclasses

import pytest
import torch

from paddle_tpu_torch.distributed import (DistributedStrategy, fleet,
                                          get_hybrid_communicate_group,
                                          topology)
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.kernels import fused_norm as fn
from paddle_tpu_torch.models import GPTHybridTrainer, gpt_tiny
from paddle_tpu_torch.optimizer import SGD

pytestmark = pytest.mark.cuda

CFG = dataclasses.replace(gpt_tiny(), hidden_size=256, num_heads=4,
                          num_layers=4)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    topology.set_hybrid_communicate_group(None)


def _gen(seed):
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    return g


def _serial(remat, card):
    return GPTHybridTrainer(dataclasses.replace(CFG, remat=remat),
                            optimizer=SGD(learning_rate=0.1), device=card,
                            generator=_gen(9))


def test_remat_replays_the_flash_and_norm_forwards(card):
    plain = _serial(False, card)
    ids, labels = plain.make_batch(2, 128, seed=3)
    want = float(plain.train_step(ids, labels))
    tr = _serial(True, card)
    kernels = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
               fa.flash_attention_bwd_dkv, fn.layer_norm_fwd,
               fn.layer_norm_bwd)
    for k in kernels:
        k.launches = 0
    got = float(tr.train_step(ids, labels))
    torch.cuda.synchronize()
    L = CFG.num_layers
    assert [k.launches for k in kernels] == [2 * L, L, L, 4 * L + 1,
                                             2 * L + 1]
    assert abs(got - want) <= 1e-6 * abs(want)


def test_sp_norms_each_ranks_rows_and_matches_serial(card, monkeypatch):
    serial = _serial(False, card)
    ids, labels = serial.make_batch(4, 96, seed=3)
    want = [float(serial.train_step(ids, labels)) for _ in range(2)]
    s = DistributedStrategy()
    s.hybrid_configs = {"mp_degree": 2, "pp_degree": 2}
    fleet.init(is_collective=True, strategy=s, devices=["cuda:0"] * 4)
    tr = GPTHybridTrainer(dataclasses.replace(CFG, sp=True, remat=True),
                          get_hybrid_communicate_group(),
                          SGD(learning_rate=0.1), microbatches=2,
                          generator=_gen(9))
    rows = []
    real = fn.layer_norm_fwd

    def counting(x, *a, **k):
        rows.append(x.shape[0])
        return real(x, *a, **k)
    counting.launches = 0
    monkeypatch.setattr(fn, "layer_norm_fwd", counting)
    got = [float(tr.train_step(ids, labels))]
    monkeypatch.setattr(fn, "layer_norm_fwd", real)
    got.append(float(tr.train_step(ids, labels)))
    mb = 4 // 2
    # per microbatch: each block's two norms on each of 2 mp ranks at
    # mb·96/2 rows (and again in the replay), ln_f on 4 vocab ranks at
    # mb·96 rows
    block = [r for r in rows if r == mb * 96 // 2]
    head = [r for r in rows if r == mb * 96]
    assert len(block) == 2 * 2 * CFG.num_layers * 2 * 2
    assert len(head) == 2 * 4 and len(rows) == len(block) + len(head)
    assert abs(got[0] - want[0]) <= 2e-4 * abs(want[0])
    assert abs(got[1] - want[1]) <= 2e-3 * abs(want[1])


def test_example_without_a_card_names_the_flag(monkeypatch):
    from paddle_tpu_torch.examples.train_gpt_hybrid import main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        main(["--steps", "1"])
