"""The ctypes bindings of the port's CUDA kernels agree with the C entry
points in parallax_tpu_torch/csrc, argument by argument, and the build
plumbing fails clearly where there is no nvcc. (The kernels themselves run
only on the card: chip_smoke.py compares each with its plain version.)"""

import ctypes
import os
import re
import shutil

import pytest

from parallax_tpu_torch.ops import cuda_kernels as ck

_C_TYPES = {
    "const void*": ctypes.c_void_p,
    "void*": ctypes.c_void_p,
    "int": ctypes.c_int,
    "long long": ctypes.c_longlong,
    "float": ctypes.c_float,
}


def _c_entries() -> dict[str, list[str]]:
    out = {}
    for name in os.listdir(ck.CSRC):
        if not name.endswith(".cu"):
            continue
        with open(os.path.join(ck.CSRC, name)) as f:
            src = f.read()
        for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', src):
            params = [" ".join(p.split()) for p in m.group(2).split(",")]
            # Drop the parameter names, keep the types.
            out[m.group(1)] = [p.rsplit(" ", 1)[0].replace(" *", "*")
                               for p in params]
    return out


def test_ctypes_signatures_match_the_c_entries():
    entries = _c_entries()
    assert set(entries) == set(ck._SIGNATURES)
    for name, c_types in entries.items():
        want = [_C_TYPES[t] for t in c_types]
        assert ck._SIGNATURES[name] == want, name
    # One entry, one launch counter, per kernel.
    assert {f"pk_{k}" for k in ck.KERNELS} == set(entries)


def test_every_source_names_the_tpu_kernel_it_replaces():
    for name in os.listdir(ck.CSRC):
        if name.endswith(".cu"):
            with open(os.path.join(ck.CSRC, name)) as f:
                head = f.read(2000)
            # A Pallas kernel of parallax_tpu/ops/, or the library kernel
            # a parallax_tpu module calls (megablox gmm in models/moe.py).
            assert "Replaces:" in head and "parallax_tpu/" in head, name
            assert "Bound on the H100" in head, name


def test_build_digest_tracks_sources_and_flags(monkeypatch):
    d0 = ck._digest()
    assert d0 == ck._digest()
    monkeypatch.setattr(ck, "NVCC_FLAGS", ck.NVCC_FLAGS + ["-DX=1"])
    assert ck._digest() != d0
    assert "arch=compute_90a,code=sm_90a" in " ".join(ck.NVCC_FLAGS)
    assert "--use_fast_math" not in ck.NVCC_FLAGS   # IEEE division (A3)


def test_missing_nvcc_raises_clearly(monkeypatch, tmp_path):
    if shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("nvcc is installed here")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(ck, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        ck.build()


def test_launch_counters_reset():
    ck.LAUNCHES["gqa_decode"] += 3
    assert ck.launches()["gqa_decode"] >= 3
    ck.reset_launches()
    assert set(ck.launches().values()) == {0}
