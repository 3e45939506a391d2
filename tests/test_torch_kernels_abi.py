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


def test_a_tally_counts_its_own_thread_alone():
    """A graph capture's tally (``into_launches=False``) takes the capturing
    thread's launches out of ``LAUNCHES`` while another thread's launches
    meanwhile still count there; an ordinary tally counts both ways."""
    import threading

    ck.reset_launches()
    inside = threading.Event()
    done = threading.Event()

    def other():
        inside.wait(10)
        for _ in range(5):
            ck.count("gqa_decode")
        done.set()

    t = threading.Thread(target=other)
    t.start()
    with ck.tally(into_launches=False) as captured:
        ck.count("kv_append")
        ck.count("kv_append")
        inside.set()
        assert done.wait(10)
        with ck.tally() as warm:
            ck.count("gqa_prefill")
        ck.count("gqa_prefill")
    t.join(10)
    assert captured == {"kv_append": 2, "gqa_prefill": 1}
    assert warm == {"gqa_prefill": 1}
    got = ck.launches()
    assert (got["gqa_decode"], got["kv_append"], got["gqa_prefill"]) == (
        5, 0, 1)
    ck.count("kv_append")
    assert ck.launches()["kv_append"] == 1
    ck.reset_launches()


def test_mla_and_indexer_entries():
    """A5-A8: one C entry and one counter each; the fused entries take the
    cache's slot count in 64 bits (DeepSeek-size caches pass 2**31 rows x
    width elements)."""
    entries = _c_entries()
    for name in ("mla_decode", "mla_attend", "indexer_fused",
                 "indexer_scores"):
        assert f"pk_{name}" in entries and name in ck.LAUNCHES
    for name in ("pk_mla_decode", "pk_indexer_fused"):
        assert entries[name].count("long long") == 1
        assert ck._SIGNATURES[name].count(ctypes.c_longlong) == 1


def test_mla_and_indexer_argument_checks():
    """The wrappers' checks (run before a launch) refuse what the kernels
    do not take."""
    import torch

    from parallax_tpu_torch.ops.dsa_decode import check_indexer_args
    from parallax_tpu_torch.ops.mla_decode import check_mla_args

    def mla(r=512, dr=64, dtype=torch.bfloat16, q_dtype=None):
        q = torch.zeros((2, 16, r), dtype=q_dtype or dtype)
        qp = torch.zeros((2, 16, dr), dtype=q_dtype or dtype)
        cache = torch.zeros((4, 64, 1, r + dr), dtype=dtype)
        return check_mla_args("mla", q, qp, cache,
                              torch.zeros(2, dtype=torch.int32),
                              torch.zeros((2, 3), dtype=torch.int32), r)

    assert mla() == (2, 16, 512, 64)
    assert mla(64, 16, torch.float32) == (2, 16, 64, 16)
    with pytest.raises(TypeError):
        mla(dtype=torch.float16)
    with pytest.raises(TypeError):
        mla(q_dtype=torch.float32)
    with pytest.raises(ValueError, match="kv_lora_rank"):
        mla(r=1024)
    with pytest.raises(ValueError, match="16 bytes"):
        mla(r=60, dr=2)

    def idx(page=64, weights=True, kind="dsa"):
        q = torch.zeros((3, 64, 128), dtype=torch.bfloat16)
        w = torch.zeros((3, 64)) if weights else None
        cache = torch.zeros((4, page, 1, 128), dtype=torch.bfloat16)
        return check_indexer_args("idx", q, w, cache,
                                  torch.zeros(3, dtype=torch.int32),
                                  torch.zeros((3, 2), dtype=torch.int32),
                                  kind)

    assert idx() == (3, 64, 128)
    assert idx(weights=False, kind="msa") == (3, 64, 128)
    with pytest.raises(ValueError, match="weights"):
        idx(weights=False)
    # Each key tile position finds its own page: any page size is taken.
    assert idx(page=48) == (3, 64, 128)
    with pytest.raises(ValueError, match="reduce_kind"):
        idx(kind="max")


def test_split_decode_entry_and_argument_checks():
    """A9 (``pk_gqa_attend``): one C entry beside A2's in gqa_decode.cu, one
    counter, no append arguments and no soft cap (K6 takes none); its
    wrapper refuses what the kernel does not take before any launch."""
    import torch

    from parallax_tpu_torch.ops.decode_fused import check_decode_args

    entries = _c_entries()
    assert "gqa_attend" in ck.LAUNCHES
    assert entries["pk_gqa_attend"].count("float") == 1   # sm_scale only
    assert entries["pk_gqa_attend"].count("long long") == 0
    with open(os.path.join(ck.CSRC, "gqa_decode.cu")) as f:
        head = f.read(2000)
    assert "attention_pallas.py::gqa_decode_attention_pallas" in head
    def check(q_dtype=torch.bfloat16, sinks_dtype=torch.float32, s=7,
              page=64, lens_dtype=torch.int32, d=64, hkv=8):
        q = torch.zeros((7, 64, d), dtype=q_dtype)
        cache = torch.zeros((4, page, 2 * hkv, d), dtype=torch.bfloat16)
        return check_decode_args(
            "gqa_attend", q, cache, torch.zeros(s, dtype=lens_dtype),
            torch.zeros((7, 12), dtype=torch.int32),
            torch.zeros(64, dtype=sinks_dtype))

    assert check() == (64, 8, 64)
    with pytest.raises(ValueError, match="sinks"):
        check(sinks_dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        check(q_dtype=torch.float32)
    with pytest.raises(ValueError, match="kv_lens"):
        check(s=6)
    with pytest.raises(ValueError, match="kv_lens"):
        check(lens_dtype=torch.int64)
    # Any page size: each key position finds its own page. Head dims and
    # group sizes are what the kernels are instantiated for.
    assert check(page=1024) == (64, 8, 64)
    assert check(d=128, hkv=2) == (64, 2, 128)
    with pytest.raises(ValueError, match="head_dim"):
        check(d=96)
    with pytest.raises(ValueError, match="group size"):
        check(hkv=1)


def _header_constants() -> dict[str, int]:
    with open(os.path.join(ck.CSRC, "attend.cuh")) as f:
        src = f.read()
    return {m.group(1): int(m.group(2)) for m in
            re.finditer(r"constexpr int (k\w+) = (\d+);", src)}


def test_split_kv_entries_take_scratch_and_split_count():
    """A1, A2 and A9 take the f32 scratch of the split partials and the
    grid's split count; the Python twins of the partition and the tile
    carve use the header's constants."""
    from parallax_tpu_torch.ops import decode_fused, prefill_fused

    entries = _c_entries()
    for name in ("pk_gqa_prefill", "pk_gqa_decode", "pk_gqa_attend"):
        names = [p.split()[-1].lstrip("*") for p in
                 re.search(name + r"\(([^)]*)\)", open(os.path.join(
                     ck.CSRC, "gqa_prefill.cu" if "prefill" in name
                     else "gqa_decode.cu")).read()).group(1).split(",")]
        assert "scratch" in names and "num_splits" in names, name
        assert len(entries[name]) == len(ck._SIGNATURES[name])
    c = _header_constants()
    assert c["kSplitKeys"] == decode_fused.SPLIT_KEYS
    assert c["kMaxSplits"] == decode_fused.MAX_SPLITS
    assert 16 * c["kTileWarps"] == prefill_fused.MAX_TILE_ROWS
    assert c["kKT"] == 64 and c["kStages"] == 2   # decode_fused.smem_bytes


@pytest.mark.parametrize("elem", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("d", [64, 128])
def test_attention_smem_carve_fits(d, elem):
    """Every block the attention kernels launch fits the H100's shared
    memory: decode blocks of 16 or 32 rows, multi-token tiles of 128 rows
    (plus the tile map's 16 static bytes)."""
    from parallax_tpu_torch.ops.decode_fused import SMEM_LIMIT, smem_bytes
    from parallax_tpu_torch.ops.prefill_fused import q_tile_for

    for rows in (16, 32, 128):
        assert smem_bytes(rows, d, elem) + 16 <= SMEM_LIMIT
    # The decode merge reuses the block's memory: WK warps' rows x (D + 2)
    # f32 values.
    for rows, wk in ((16, 4), (32, 2)):
        assert wk * rows * (d + 2) * 4 <= smem_bytes(rows, d, elem)
    assert [q_tile_for(g) for g in (1, 3, 7, 8, 20, 32)] == [
        128, 42, 18, 16, 6, 4]


def test_kv_append_argument_checks():
    """A0 copies 16-byte vectors: its wrapper refuses a head dim that is not
    a multiple of 8 bf16 (4 f32) values, a misaligned tensor, and k / v of
    another dtype than the cache (the wrapper casts them before the
    checks)."""
    import torch

    from parallax_tpu_torch.ops.kv_cache_ops import check_kv_append_args

    def check(d=128, dtype=torch.bfloat16, kv_dtype=None, t=5, hkv=4,
              slots_dtype=torch.int32, offset=0):
        cache = torch.zeros((3, 16, 2 * hkv, d), dtype=dtype)
        flat = torch.zeros(t * hkv * d + offset, dtype=kv_dtype or dtype)
        k = flat[offset:].view(t, hkv, d)
        v = torch.zeros((t, hkv, d), dtype=kv_dtype or dtype)
        return check_kv_append_args(cache, k, v,
                                    torch.zeros(t, dtype=slots_dtype))

    assert check() == (5, 4, 128)
    assert check(d=64, dtype=torch.float32) == (5, 4, 64)
    assert check(d=8) == (5, 4, 8)
    assert check(d=4, dtype=torch.float32) == (5, 4, 4)
    with pytest.raises(ValueError, match="multiple of 8"):
        check(d=60)
    with pytest.raises(ValueError, match="multiple of 4"):
        check(d=6, dtype=torch.float32)
    with pytest.raises(ValueError, match="16-byte aligned"):
        check(offset=1)
    with pytest.raises(TypeError, match="cache's dtype"):
        check(kv_dtype=torch.float32)
    with pytest.raises(TypeError, match="not supported"):
        check(dtype=torch.float16)
    with pytest.raises(ValueError, match="slot_mapping"):
        check(slots_dtype=torch.int64)


def test_grouped_gemm_argument_checks_and_variant_entry():
    """A4's C entry takes the forced variant (0 = by M, 1 = prefill, 2 =
    decode); the wrapper's checks refuse what the kernel does not take and
    any other variant, on the CPU as on the card."""
    import torch

    from parallax_tpu_torch.ops.grouped_matmul import (
        VARIANTS,
        check_grouped_args,
        grouped_matmul,
    )

    with open(os.path.join(ck.CSRC, "grouped_gemm.cu")) as f:
        src = f.read()
    params = re.search(r"pk_grouped_gemm\(([^)]*)\)", src).group(1)
    names = [p.split()[-1].lstrip("*") for p in params.split(",")]
    assert names[-2:] == ["variant", "stream"]
    assert VARIANTS == {None: 0, "prefill": 1, "decode": 2}

    def check(dtype=torch.bfloat16, off_dtype=torch.int32, k=64,
              variant=None, offset=0):
        flat = torch.zeros(6 * k + offset, dtype=dtype)
        lhs = flat[offset:].view(6, k)
        rhs = torch.zeros((2, 24, k), dtype=dtype)
        offs = torch.tensor([0, 2, 6], dtype=off_dtype)
        return check_grouped_args(lhs, rhs, offs, variant)

    assert check() == (6, 24, 64, 2)
    assert check(k=40, variant="decode") == (6, 24, 40, 2)
    assert check(variant="prefill") == (6, 24, 64, 2)
    with pytest.raises(TypeError, match="bf16"):
        check(dtype=torch.float32)
    with pytest.raises(TypeError, match="int32"):
        check(off_dtype=torch.int64)
    with pytest.raises(ValueError, match="multiple of 8"):
        check(k=12)
    with pytest.raises(ValueError, match="16-byte aligned"):
        check(offset=1)
    for bad in ("fast", 1, "Decode"):
        with pytest.raises(ValueError, match="variant"):
            check(variant=bad)
    lhs, rhs = torch.ones((6, 8)), torch.ones((2, 3, 8))
    offs = torch.tensor([0, 2, 6], dtype=torch.int32)
    with pytest.raises(ValueError, match="variant"):
        grouped_matmul(lhs, rhs, offs, _variant="fast")
    # On CPU tensors a forced variant still takes the plain version.
    assert torch.equal(grouped_matmul(lhs, rhs, offs, _variant="decode"),
                       torch.full((6, 3), 8.0))


def test_kernel_library_is_returned_without_the_lock(monkeypatch):
    """Once loaded, ``lib()`` returns the library without taking the build
    lock (every wrapper calls it on every launch)."""
    sentinel = object()

    class NoLock:
        def __enter__(self):
            raise AssertionError("lib() took the lock")

        def __exit__(self, *a):
            return False

    monkeypatch.setattr(ck, "_lib", sentinel)
    monkeypatch.setattr(ck, "_lock", NoLock())
    assert ck.lib() is sentinel


def test_stream_of_reads_the_raw_handle_or_the_public_stream(monkeypatch):
    """``stream_of`` uses torch's raw-stream getter where the build has it
    and the public ``torch.cuda.current_stream`` where it does not (a
    CPU-only build, or a torch that renamed the private function)."""
    import types

    import torch

    t = types.SimpleNamespace(device=torch.device("cuda", 3))
    monkeypatch.setattr(ck, "_raw_stream", lambda index: 1000 + index)
    assert ck.stream_of(t) == 1003
    monkeypatch.setattr(ck, "_raw_stream", None)
    monkeypatch.setattr(
        torch.cuda, "current_stream",
        lambda device: types.SimpleNamespace(cuda_stream=2000 + device.index))
    assert ck.stream_of(t) == 2003


def _source_constants(name: str) -> dict[str, int]:
    with open(os.path.join(ck.CSRC, name)) as f:
        src = f.read()
    return {m.group(1): int(m.group(2)) for m in
            re.finditer(r"constexpr int (k\w+) = (\d+);", src)}


def _entry_params(name: str, source: str) -> list[str]:
    with open(os.path.join(ck.CSRC, source)) as f:
        src = f.read()
    return [p.split()[-1].lstrip("*") for p in
            re.search(name + r"\(([^)]*)\)", src).group(1).split(",")]


def test_mla_split_entries_constants_and_carve():
    """A5 / A6 take the f32 scratch of their split partials and the grid's
    split count; the Python twins use the source's constants; the split
    block's carve fits 227 KB for both cache dtypes at DeepSeek's widths
    (R 512 + Dr 64) and at the widest row the wrappers take."""
    from parallax_tpu_torch.ops import mla_decode as md

    for name in ("pk_mla_decode", "pk_mla_attend"):
        params = _entry_params(name, "mla_decode.cu")
        assert "scratch" in params and "num_splits" in params, name
    c = _source_constants("mla_decode.cu")
    assert c["kKT"] == md.KEY_TILE
    assert c["kSplitKeys"] == md.SPLIT_KEYS
    assert c["kMaxSplits"] == md.MAX_SPLITS <= 32   # one combine lane each
    assert 2 * c["kHalfCols"] == md.MAX_LATENT
    for elem in (2, 4):
        assert md.mla_smem_bytes(576, elem) <= md.SMEM_LIMIT
    assert md.mla_smem_bytes(576, 2) == 201728     # bf16: 64 heads, 3 stages
    assert md.mla_smem_bytes(576, 4) == 190720     # f32: 16 heads, 2 stages
    # The partial's staging reuses the query tile and the ring.
    for elem in (2, 4):
        heads = md.HEADS_PER_BLOCK[elem]
        assert (heads * md.mla_part_stride(512) * 4
                <= md.mla_smem_bytes(576, elem) - 1024 - heads // 8 * 2048)
    # The grid bound: 16 splits at 1,024 tokens of page 64 (the smoke's
    # page table) and at 8,192; one split a page under 64 keys.
    assert md.mla_num_splits_bound(16, 64) == 16
    assert md.mla_num_splits_bound(128, 64) == 16
    assert md.mla_num_splits_bound(1, 64) == 1
    assert md.mla_num_splits_bound(8, 16) == 2
    assert len(md.mla_split_ranges(732, 64)) == 12
    assert len(md.mla_split_ranges(8192, 64)) == 16


def test_sample_topk_entry_takes_workspace_and_chunking():
    """A3's entry takes its workspace and the host's chunking (C, L); its
    wrapper sizes the workspace S x (C x (64 + 2) + 1) words."""
    params = _entry_params("pk_sample_topk", "sample_topk.cu")
    assert params[5:10] == ["workspace", "s", "vocab", "chunks", "chunk_len"]
    assert len(ck._SIGNATURES["pk_sample_topk"]) == len(params)


def test_indexer_entries_take_the_block_count():
    """A7 / A8 take the grid's blocks per row, which the wrappers pick from
    the row count alone (indexer_blocks), and the Python twins use the
    source's constants."""
    from parallax_tpu_torch.ops import dsa_decode as dd

    for name in ("pk_indexer_fused", "pk_indexer_scores"):
        params = _entry_params(name, "indexer_scores.cu")
        assert params[params.index("pps") + 1] == "blocks", name
        assert len(ck._SIGNATURES[name]) == len(params), name
    c = _source_constants("indexer_scores.cu")
    assert c["kKeyTile"] == dd.KEY_TILE
    assert c["kHeadTile"] == dd.HEAD_TILE
    assert c["kStages"] == dd.STAGES
    assert c["kFmaStages"] == dd.FMA_STAGES
    assert c["kMaxTcDepth"] == dd.MAX_TC_DEPTH
    assert c["kThreads"] == dd.THREADS == 128   # one warpgroup
    # At most three blocks an SM at the smoke shape's 7 rows, at most half
    # the page slots (no block per slot), one per row at least.
    assert dd.indexer_blocks(7, 48) == 24
    assert dd.indexer_blocks(7, 512) == 56
    assert 7 * 56 <= 3 * 132
    assert dd.indexer_blocks(7, 8) == 4
    assert dd.indexer_blocks(7, 7) == 4
    assert dd.indexer_blocks(1000, 2560) == 1
    assert dd.indexer_blocks(1, 1) == 1
    assert dd.indexer_blocks(1, 2) == 1
    # Both entries take the cache's slot count in 64 bits (A8's for the
    # tensor map of its cache).
    for name in ("pk_indexer_fused", "pk_indexer_scores"):
        params = _entry_params(name, "indexer_scores.cu")
        assert params[params.index("blocks") + 1] == "total_slots", name


@pytest.mark.parametrize("hi,d", [(64, 128), (16, 64)],
                         ids=["dsa_v32", "msa_minimax_m3"])
@pytest.mark.parametrize("elem", [2, 4], ids=["bf16", "f32"])
def test_indexer_smem_carve_fits(hi, d, elem):
    """Every registered indexer geometry (DeepSeek-V3.2's DSA, MiniMax-M3's
    MSA) fits 227 KB in either cache dtype and at the engine's page sizes;
    bf16 takes the tensor-core body, whose carve is 1 KB of alignment, the
    64-row query tile, the ring, each warp's 16 staged scores and each
    stage's mbarrier and append row."""
    from parallax_tpu_torch.ops import dsa_decode as dd

    for page in (16, 64, 128):
        smem = dd.indexer_smem_bytes(hi, d, elem, page)
        assert smem <= dd.SMEM_LIMIT
        assert dd.indexer_uses_tensor_cores(hi, d, elem, page) == (elem == 2)
        if elem == 2:
            assert smem == (1024 + 64 * d * 2 + dd.STAGES * 64 * d * 2
                            + 4 * 16 * 4 + 12 * dd.STAGES)
            # TARGET_BLOCKS / 132 blocks of it share an SM (228 KB, 1 KB
            # reserved a block).
            assert (dd.TARGET_BLOCKS // 132) * (smem + 1024) <= 228 * 1024
    # The presets hold these geometries.
    from parallax_tpu_torch.models.presets import get_preset

    geoms = {(c.index_n_heads, c.index_head_dim) for c in (
        get_preset("deepseek-ai/DeepSeek-V3.2-Exp").dsa,
        get_preset("MiniMaxAI/MiniMax-M3").msa)}
    assert (hi, d) in geoms


def test_indexer_argument_checks_follow_the_kernel():
    """check_indexer_args refuses exactly what the kernel does not take: a
    query or cache row that is not whole 16-byte units, a misaligned
    cache, and a carve past 227 KB (only the CUDA-core body at large Hi x
    D); it takes any page size, and bf16 shapes outside the tensor-core
    body (Hi > 64, D not a multiple of 64, pages not a multiple of 8)."""
    import torch

    from parallax_tpu_torch.ops import dsa_decode as dd

    def idx(hi=64, d=128, page=64, dtype=torch.bfloat16, offset=0):
        q = torch.zeros((2, hi, d), dtype=dtype)
        buf = torch.zeros(4 * page * d + offset, dtype=dtype)
        cache = buf[offset:].view(4, page, 1, d)
        return dd.check_indexer_args("idx", q, torch.zeros((2, hi)), cache,
                                     torch.zeros(2, dtype=torch.int32),
                                     torch.zeros((2, 3), dtype=torch.int32),
                                     "dsa")

    for page in (1, 3, 16, 48, 64, 256, 1024):
        assert idx(page=page) == (2, 64, 128)
    assert idx(hi=128) == (2, 128, 128)                 # CUDA-core body
    assert idx(d=32) == (2, 64, 32)
    assert idx(hi=8, d=32, page=16, dtype=torch.float32) == (2, 8, 32)
    assert not dd.indexer_uses_tensor_cores(128, 128, 2, 64)
    assert not dd.indexer_uses_tensor_cores(64, 96, 2, 64)
    assert not dd.indexer_uses_tensor_cores(64, 128, 2, 12)
    assert dd.indexer_uses_tensor_cores(64, 256, 2, 64)
    assert dd.indexer_uses_tensor_cores(64, 128, 2, 8)
    assert dd.indexer_uses_tensor_cores(64, 128, 2, 48)
    with pytest.raises(ValueError, match="16 bytes"):
        idx(d=12)
    with pytest.raises(ValueError, match="16 bytes"):
        idx(offset=1)
    with pytest.raises(ValueError, match="too large"):
        idx(hi=256, d=256, dtype=torch.float32)
    with pytest.raises(TypeError):
        idx(dtype=torch.float16)
    # The wrappers' 16-byte copies of q and k_new: a misaligned view raises.
    buf = torch.zeros(2 * 128 + 1, dtype=torch.bfloat16)
    assert dd.aligned_rows("idx", buf[:256].view(2, 128)).data_ptr() % 16 == 0
    with pytest.raises(ValueError, match="16-byte aligned"):
        dd.aligned_rows("idx", buf[1:].view(2, 128))
