"""The durable request journal of the PyTorch port
(``paddle_tpu_torch/serving/journal.py``) against the JAX package's, on
the CPU.

The journal is host code and its bytes are the reference's: the same
records (with an explicit ``wall_time``) give byte-identical segments in
both packages, and each package opens the other's journal to the same
``ledger()`` and ``replay()``.  The reference's single-journal cases
(``tests/test_zz_crash_serving.py``) run against the port: rotation and
compaction, a record attributed to the segment it landed in, a pended
submit's forced fsync, the torn-write fuzz at every byte offset (each
cut opened by both packages), a corrupt sealed segment, the
``journal_replay`` / ``journal_write`` / ``journal_fsync`` faults.

At engine level a gpt_tiny ``ServingEngine(journal=)`` in each package
(weights carried by ``state_dict_from_jax``) serves the same greedy
prompts: equal tokens, an equal ``ledger()`` and equal terminal records.
``progress`` records are compared only through the ledger: the port runs
every prefill through one staging lane, one request's chunks at a time,
so its step schedule, and with it the batching of the delivered marks,
differs from the reference's.  Then the port alone: a reopened journal
offsets the ids, a cancel and a deadline each give one terminal, a
quarantine gives exactly one terminal a request.
"""

import dataclasses
import os

import numpy as np
import pytest

import paddle_tpu
import paddle_tpu.serving as jax_serving
import paddle_tpu.serving.journal as jax_journal
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import gpt_tiny as jax_gpt_tiny
import paddle_tpu_torch.serving as port_serving
import paddle_tpu_torch.serving.journal as port_journal
from paddle_tpu_torch.models import (GPTForCausalLM, gpt_tiny,
                                     state_dict_from_jax)
from paddle_tpu_torch.serving import (FaultInjector, FaultToleranceConfig,
                                      Journal, JournalError, SamplingParams,
                                      ServingEngine)

SIDES = {"jax": jax_journal, "port": port_journal}


def _write_history(mod, path):
    """The same records through one package's journal: rotation at 4 KiB,
    every kind, explicit wall times."""
    j = mod.Journal.open(str(path), fsync=False, segment_bytes=4096)
    try:
        for rid in range(24):
            j.append_submit(rid, list(range(rid, rid + 30)), 8,
                            sampling={"do_sample": bool(rid % 2),
                                      "temperature": 0.8, "top_k": 5,
                                      "top_p": 1.0, "seed": rid},
                            eos_token_id=None if rid % 3 else 2,
                            deadline_s=1.5 if rid % 4 == 0 else None,
                            wall_time=1000.0 + rid, priority="batch"
                            if rid % 5 == 0 else "interactive")
            j.append_progress({rid: 3, max(rid - 1, 0): 5})
            if rid % 3:
                j.append_terminal(rid, "finished", "length", delivered=8)
    finally:
        j.close()


def _segments(path):
    return {f: (path / f).read_bytes() for f in sorted(os.listdir(path))}


def _views(mod, path):
    j = mod.Journal.open(str(path), fsync=False)
    try:
        return j.ledger(), j.replay(), list(j.records())
    finally:
        j.close()


def test_segments_are_byte_identical_across_packages(tmp_path):
    for side, mod in SIDES.items():
        _write_history(mod, tmp_path / side)
    ref, port = _segments(tmp_path / "jax"), _segments(tmp_path / "port")
    assert len(port) > 1                       # rotation happened
    assert port == ref


@pytest.mark.parametrize("writer,reader", [("jax", "port"),
                                           ("port", "jax")])
def test_each_package_opens_the_others_journal(tmp_path, writer, reader):
    _write_history(SIDES[writer], tmp_path / "wal")
    assert _views(SIDES[reader], tmp_path / "wal") == \
        _views(SIDES[writer], tmp_path / "wal")


# ------------------------------------------- the reference's journal cases

def test_roundtrip_rotation_and_compaction(tmp_path):
    journal = Journal.open(str(tmp_path / "wal"), fsync=False,
                           segment_bytes=4096)
    try:
        for rid in range(30):
            journal.append_submit(rid, [1, 2, rid], 4,
                                  sampling={"do_sample": False,
                                            "seed": rid})
            journal.append_progress({rid: 2})
            if rid < 25:
                journal.append_terminal(rid, "finished", "length",
                                        delivered=4)
    finally:
        journal.close()
    journal = Journal.open(str(tmp_path / "wal"), fsync=False,
                           segment_bytes=4096)
    try:
        assert len(journal.segments) > 1
        led = journal.ledger()
        assert len(led) == 30
        for rid in range(25):
            assert led[rid]["terminals"] == 1
            assert led[rid]["status"] == "finished"
            assert led[rid]["delivered"] == 4
        replay = journal.replay()
        assert sorted(replay) == [25, 26, 27, 28, 29]
        assert replay[25]["delivered"] == 2
        assert replay[25]["record"]["prompt"] == [1, 2, 25]
        assert replay[25]["record"]["sampling"]["seed"] == 25
        before = len(journal.segments)
        removed = journal.compact()
        assert removed >= 1
        assert len(journal.segments) == before - removed
    finally:
        journal.close()
    journal = Journal.open(str(tmp_path / "wal"), fsync=False)
    try:
        assert sorted(journal.replay()) == [25, 26, 27, 28, 29]
    finally:
        journal.close()


def test_rotation_attributes_record_to_landing_segment(tmp_path):
    """A record whose append rotates lands in the NEW segment and is
    attributed there, so compaction never deletes a live request's only
    submit record."""
    journal = Journal.open(str(tmp_path / "wal"), fsync=False,
                           segment_bytes=4096)
    rid = 0
    while journal._fh.tell() < 4096 - 400:
        journal.append_submit(rid, list(range(20)), 4)
        journal.append_terminal(rid, "finished", "length", delivered=4)
        rid += 1
    assert len(journal.segments) == 1
    live = 10_000
    journal.append_submit(live, list(range(150)), 4)
    assert len(journal.segments) == 2
    while len(journal.segments) == 2:
        journal.append_submit(rid, list(range(20)), 4)
        journal.append_terminal(rid, "finished", "length")
        rid += 1
    assert journal.compact() == 1
    journal.close()
    j2 = Journal.open(str(tmp_path / "wal"), fsync=False)
    assert live in j2.replay(), sorted(j2.replay())
    j2.close()


def test_pended_submit_keeps_forced_fsync_class(tmp_path):
    faults = FaultInjector()
    journal = Journal.open(str(tmp_path / "wal"), fsync=False,
                           fsync_batch=100, faults=faults)
    try:
        faults.enable("journal_write", times=1)
        try:
            journal.append_submit(0, [1, 2, 3], 4)
        finally:
            faults.disable("journal_write")
        assert journal.write_failures == 1
        synced_before = journal.fsyncs
        journal.append_progress({0: 1})
        assert journal.position()["pending_writes"] == 0
        assert journal.fsyncs == synced_before + 1
    finally:
        journal.close()


def test_torn_write_fuzz_every_byte_offset(tmp_path):
    """Truncated at every byte offset inside its tail record, the journal
    opens in both packages to the same ledger: the synced submit is never
    lost, the torn frame never half-applied, and appending is clean."""
    base = tmp_path / "wal"
    journal = Journal.open(str(base), fsync=False)
    journal.append_submit(0, [5, 6, 7], 4,
                          sampling={"do_sample": False, "seed": 0})
    journal.append_progress({0: 3})
    journal.close()
    data = (base / "wal-00000001.seg").read_bytes()
    intact = data.rfind(b'{"kind":"progress"') - 8
    assert intact > 0
    for cut in range(intact, len(data) + 1):
        leds = {}
        for side, mod in SIDES.items():
            d = tmp_path / f"fuzz-{side}-{cut}"
            d.mkdir()
            (d / "wal-00000001.seg").write_bytes(data[:cut])
            j = mod.Journal.open(str(d), fsync=False)
            try:
                led = j.ledger()
                assert led[0]["submits"] == 1
                assert led[0]["delivered"] == (3 if cut == len(data)
                                               else 0)
                j.append_terminal(0, "finished", "length", delivered=4)
                leds[side] = (led, j.ledger())
            finally:
                j.close()
        assert leds["port"] == leds["jax"]


def test_sealed_segment_corruption_is_loud(tmp_path):
    journal = Journal.open(str(tmp_path / "wal"), fsync=False,
                           segment_bytes=4096)
    for rid in range(30):
        journal.append_submit(rid, list(range(40)), 4)
    journal.close()
    segs = sorted((tmp_path / "wal").glob("wal-*.seg"))
    assert len(segs) > 1
    data = segs[0].read_bytes()
    segs[0].write_bytes(data[:len(data) // 2])
    with pytest.raises(JournalError, match="sealed segment"):
        Journal.open(str(tmp_path / "wal"), fsync=False)


def test_journal_replay_fault_single_retries_double_raises(tmp_path):
    journal = Journal.open(str(tmp_path / "wal"), fsync=False)
    journal.append_submit(0, [1, 2, 3], 4)
    journal.append_submit(1, [4, 5], 4)
    journal.close()
    faults = FaultInjector()
    faults.enable("journal_replay", times=1)
    try:
        j = Journal.open(str(tmp_path / "wal"), fsync=False, faults=faults)
    finally:
        faults.disable("journal_replay")
    assert j.replay_retries_used == 1
    assert sorted(j.replay()) == [0, 1]
    j.close()
    faults.enable("journal_replay", times=2)
    try:
        with pytest.raises(JournalError, match="replay failed"):
            Journal.open(str(tmp_path / "wal"), fsync=False, faults=faults)
    finally:
        faults.disable("journal_replay")
    j = Journal.open(str(tmp_path / "wal"), fsync=False)
    assert sorted(j.replay()) == [0, 1]
    j.close()


# ----------------------------------------------------------- engine level

def _prompts(seed, lengths, vocab=256):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, vocab, (n,)) for n in lengths]


@pytest.fixture(scope="module")
def models():
    """A gpt_tiny in each package with the same weights (f32)."""
    paddle_tpu.seed(0)
    jm = JaxGPT(jax_gpt_tiny())
    jm.eval()
    arrays = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    tm = GPTForCausalLM(gpt_tiny(), device="cpu")
    tm.load_state_dict(state_dict_from_jax(arrays, "cpu", "float32"))
    return {"jax": jm, "port": tm.eval()}


def _journaled(side, model, path):
    ns = jax_serving if side == "jax" else port_serving
    journal = ns.Journal.open(str(path), fsync=False)
    eng = ns.ServingEngine(model, num_slots=2, min_bucket=8,
                           enable_prefix_cache=False, journal=journal)
    rids = [eng.submit(p, max_new_tokens=5)
            for p in _prompts(5, (5, 7, 6))]
    eng.run_until_complete(200)
    journal.close()
    reader = port_journal.Journal.open(str(path), fsync=False)
    terminals = [r for r in reader.records() if r["kind"] == "terminal"]
    reader.close()
    return ([list(map(int, eng.result(r).tokens)) for r in rids],
            journal.ledger(), sorted(terminals, key=lambda r: r["id"]))


def test_engine_journal_matches_the_jax_engine(tmp_path, models):
    got = {side: _journaled(side, models[side], tmp_path / side)
           for side in ("jax", "port")}
    tokens, ledger, terminals = got["port"]
    assert tokens == got["jax"][0]
    assert ledger == got["jax"][1]
    assert terminals == got["jax"][2]
    assert all(v["submits"] == v["terminals"] == 1
               and v["delivered"] == 5 for v in ledger.values())


def _port_engine(models, journal, **kw):
    return ServingEngine(models["port"], num_slots=2, min_bucket=8,
                         journal=journal, **kw)


@pytest.mark.parametrize("site,times", [("journal_write", 1),
                                        ("journal_write", 2),
                                        ("journal_fsync", 1),
                                        ("journal_fsync", 2)])
def test_journal_faults_fail_no_request(tmp_path, models, site, times):
    faults = FaultInjector()
    journal = Journal.open(str(tmp_path / "wal"), fsync=False,
                           faults=faults)
    eng = _port_engine(models, journal)
    faults.enable(site, at=1, times=times)
    try:
        rids = [eng.submit(p, max_new_tokens=4)
                for p in _prompts(50 + times, (4, 6, 5))]
        eng.run_until_complete(200)
    finally:
        faults.disable(site)
    assert faults.fired[site] == times
    # a write fault pends the record; a second one fails its retry,
    # which the journal does not count again
    if site == "journal_write":
        assert journal.write_failures >= 1
    else:
        assert journal.fsync_failures == times
    assert all(eng.result(r).status == "finished" for r in rids)
    journal.flush()
    assert journal.position()["pending_writes"] == 0
    journal.close()
    j2 = Journal.open(str(tmp_path / "wal"), fsync=False)
    assert {r: (v["submits"], v["terminals"], v["delivered"])
            for r, v in j2.ledger().items()} == \
        {r: (1, 1, 4) for r in rids}
    j2.close()


def test_engine_reopen_offsets_request_ids(tmp_path, models):
    journal = Journal.open(str(tmp_path / "wal"), fsync=False)
    journal.append_submit(0, [1, 2, 3], 4)
    journal.append_submit(1, [4, 5], 4)
    journal.close()
    j2 = Journal.open(str(tmp_path / "wal"), fsync=False)
    eng = _port_engine(models, j2)
    rid = eng.submit([7, 8, 9], max_new_tokens=2)
    assert rid == 2
    eng.run_until_complete(200)
    led = j2.ledger()
    assert led[0]["submits"] == 1 and led[0]["terminals"] == 0
    assert led[rid]["terminals"] == 1
    assert eng.registry.snapshot()["journal.records"] == \
        j2.records_appended
    j2.close()


def test_cancel_and_deadline_each_give_one_terminal(tmp_path, models):
    journal = Journal.open(str(tmp_path / "wal"), fsync=False)
    eng = _port_engine(models, journal)
    p1, p2, p3 = _prompts(72, (5, 6, 7))
    r1 = eng.submit(p1, max_new_tokens=6)
    r2 = eng.submit(p2, max_new_tokens=6)
    r3 = eng.submit(p3, max_new_tokens=6, deadline_s=0.0)
    for _ in range(3):
        eng.step()
    eng.cancel(r2)
    eng.cancel(r2)                              # idempotent
    eng.run_until_complete(200)
    led = journal.ledger()
    assert [led[r]["status"] for r in (r1, r2, r3)] == \
        ["finished", "cancelled", "deadline_exceeded"]
    assert all(led[r]["submits"] == led[r]["terminals"] == 1
               for r in (r1, r2, r3))
    assert led[r1]["delivered"] == 6
    submit = [r for r in journal.records() if r["kind"] == "submit"]
    assert submit[0]["sampling"] == dataclasses.asdict(SamplingParams())
    journal.close()


def test_quarantine_gives_one_terminal_a_request(tmp_path, models):
    journal = Journal.open(str(tmp_path / "wal"), fsync=False)
    faults = FaultInjector()
    eng = _port_engine(models, journal, faults=faults,
                       fault_tolerance=FaultToleranceConfig(
                           max_step_retries=1, backoff_base_s=0.0))
    rids = [eng.submit(p, max_new_tokens=5)
            for p in _prompts(9, (5, 6, 7, 8))]
    faults.enable("step", at=1, times=2)
    try:
        eng.run_until_complete(200)
    finally:
        faults.disable("step")
    assert eng.metrics_dict()["quarantines"] == 1
    led = journal.ledger()
    statuses = [eng.result(r).status for r in rids]
    assert statuses == ["failed", "failed", "finished", "finished"]
    assert [led[r]["status"] for r in rids] == statuses
    assert all(led[r]["submits"] == led[r]["terminals"] == 1
               for r in rids)
    journal.close()
