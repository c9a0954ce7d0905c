"""``paddle_tpu_torch.kernels.sass`` (the reading of ``cuobjdump -sass``
that chip_smoke.py uses to hold the 16-bit flash kernels to wgmma and TMA
with no local-memory spills, and that compares two builds instruction for
instruction) on the CPU, with the dump of a small made-up library in
place of the tool's output."""

import subprocess
import types

import pytest

from paddle_tpu_torch.kernels import sass

NS = "_ZN51_GLOBAL__N__85b31df9_18_flash_attention_cu_2c138979"
FWD = NS + "16fwd_wgmma_kernelI13__nv_bfloat16Li128ELb0EEEvNS_9FwdParamsE"
DQ = NS + "15dq_wgmma_kernelI6__halfLi64ELb1EEEvNS_9BwdParamsE"
OPS = ("HGMMA", "UTMALDG", "HMMA", "STL", "LDL")


def _dump(fwd_body, dq_body):
    def function(name, body):
        lines = [f"\t\tFunction : {name}", "\t.headerflags\t@\"EF_CUDA_SM90\""]
        for i, inst in enumerate(body):
            lines.append(f"        /*{i * 16:04x}*/   {inst} ;"
                         f"   /* 0x000fe20000000f00 */")
            lines.append("                      /* 0x000fe40000000f00 */")
        return lines
    return "\n".join(["", "Fatbin elf code:", *function(FWD, fwd_body),
                      *function(DQ, dq_body)]) + "\n"


@pytest.fixture
def dumps(monkeypatch):
    """Two made-up builds, by library path."""
    fwd = ["HGMMA.64x128x16.F32.BF16 R24, gdesc[UR16], RZ, !UPT",
           "UTMALDG.4D [UR8], [UR4]", "@P0 HGMMA.64x128x16.F32.BF16 R24, "
           "gdesc[UR16], R24, gsb0", "MUFU.EX2 R23, R23", "EXIT"]
    # a body that spills: a store to and a load from local memory
    dq = ["HGMMA.64x64x16.F32.BF16 R24, gdesc[UR8], RZ, !UPT",
          "STL.64 [R1+0x8], R24", "LDL.64 R24, [R1+0x8]", "EXIT"]
    libs = {"old.so": _dump(fwd, dq),
            "new.so": _dump(fwd, ["HGMMA.64x64x16.F32.BF16 R26, gdesc[UR8], "
                                  "RZ, !UPT", "EXIT"])}
    monkeypatch.setattr(sass, "_cuobjdump", lambda: "cuobjdump")

    def run(cmd, **kw):
        assert cmd[:2] == ["cuobjdump", "-sass"]
        return types.SimpleNamespace(stdout=libs[cmd[2]])
    monkeypatch.setattr(subprocess, "run", run)
    return libs


def test_kernel_name_drops_the_anonymous_namespace():
    assert sass._kernel_name(FWD) == (
        "fwd_wgmma_kernelI13__nv_bfloat16Li128ELb0EEEvNS_9FwdParamsE")
    assert sass._kernel_name(DQ) == "dq_wgmma_kernelI6__halfLi64ELb1EEEvNS_" \
        "9BwdParamsE"
    assert sass._kernel_name("_Z4mainv") == "_Z4mainv"
    # a hash whose digits "51" are the length of the span that follows
    # them up to the end of "fwd_wgmma_kernel": the namespace's own length
    # prefix says where the kernel's name starts
    ns = "_GLOBAL__N__85b351df_18_flash_attention_cu_2c138979"
    assert sass._kernel_name(f"_ZN{len(ns)}{ns}16fwd_wgmma_kernelI6__half"
                             f"Li64ELb0EEEvNS_9FwdParamsE") == \
        "fwd_wgmma_kernelI6__halfLi64ELb0EEEvNS_9FwdParamsE"


def test_functions_and_counts(dumps):
    funcs = sass.functions("old.so")
    assert sorted(funcs) == sorted(sass._kernel_name(n) for n in (FWD, DQ))
    assert funcs[sass._kernel_name(DQ)] == [
        "HGMMA.64x64x16.F32.BF16 R24, gdesc[UR8], RZ, !UPT",
        "STL.64 [R1+0x8], R24", "LDL.64 R24, [R1+0x8]", "EXIT"]
    counts = sass.instruction_counts("old.so", "fwd_wgmma_kernel", OPS)
    assert counts == {sass._kernel_name(FWD): {
        "HGMMA": 2, "UTMALDG": 1, "HMMA": 0, "STL": 0, "LDL": 0, "total": 5}}
    assert sass.instruction_counts("old.so", "dq_wgmma_kernel", OPS) == {
        sass._kernel_name(DQ): {"HGMMA": 1, "UTMALDG": 0, "HMMA": 0,
                                "STL": 1, "LDL": 1, "total": 4}}
    assert sass.instruction_counts("new.so", "dq_wgmma_kernel", OPS)[
        sass._kernel_name(DQ)]["STL"] == 0


def test_compare_finds_the_changed_kernel(dumps, capsys):
    report = sass.compare("old.so", "new.so", ("dq_wgmma_kernel",
                                               "fwd_wgmma_kernel"))
    assert report[sass._kernel_name(FWD)] == {"old": 5, "new": 5,
                                              "same": True}
    assert report[sass._kernel_name(DQ)]["same"] is False
    assert sass.main(["compare", "old.so", "new.so", "fwd_wgmma_kernel"]) == 0
    assert sass.main(["compare", "old.so", "new.so", "dq_wgmma_kernel"]) == 1
    assert "DIFFERENT" in capsys.readouterr().out
