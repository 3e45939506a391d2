"""The port's K-step decode window on the CPU (tests/_torch_multistep.py has
the suite's model and helpers): the bit-identity matrix — greedy and
seeded streams of K = 4 overlapped, K = 4 synchronous, K = 4 pipelined
and adaptive windows equal to K = 1 synchronous — and the window
planner's unit cases (page chaining, room and budget clamps, fed-ahead
commits, device-token substitution, the CUDA graphs switch)."""

import pytest
import torch

from parallax_tpu_torch.models import create_stage_model
from parallax_tpu_torch.runtime.batch import (
    BucketSpec,
    HostStaging,
    assemble,
    substitute_device_tokens,
)
from parallax_tpu_torch.runtime.engine import (
    EngineConfig,
    StageEngine,
)
from parallax_tpu_torch.runtime.scheduler import (
    BatchPlan,
    ScheduledSeq,
)
from tests._torch_multistep import (
    CFG,
    GREEDY,
    MIXED,
    _build_engine,
    _decoding,
    _drive_requests,
    _params,
    _windows,
)


@pytest.mark.parametrize("lookahead,overlap,pipeline", [
    (4, True, 1), (4, False, 1), (4, True, 2), (None, True, 1),
], ids=["k4-overlap", "k4-sync", "k4-pipeline2", "adaptive-overlap"])
@pytest.mark.parametrize("specs", [GREEDY, MIXED], ids=["greedy", "seeded"])
def test_window_streams_bitwise_equal_k1_sync(lookahead, overlap, pipeline,
                                              specs):
    """Greedy and seeded streams are bitwise the K = 1 synchronous
    engine's, whatever K, the overlap or the chaining."""
    base, _ = _drive_requests(_build_engine(1, overlap=False), specs,
                              max_new=13)
    eng = _build_engine(lookahead, overlap=overlap, pipeline=pipeline)
    multi, _ = _drive_requests(eng, specs, max_new=13)
    for b, m in zip(base, multi):
        assert m.output_ids == b.output_ids, (b.output_ids, m.output_ids)
        assert m.status == b.status
    assert _windows(eng) > 0
    summary = eng.kernel_dispatch_summary()
    assert summary["cuda_graphs"] is False and "graphs" not in summary


def test_cuda_graphs_switch_on_the_cpu():
    """``cuda_graphs`` follows decode_fused's rule: None is off on a CPU
    device (the eager loop), True raises there."""
    eng = _build_engine(4)
    assert eng.kernel_dispatch_summary()["cuda_graphs"] is False
    with pytest.raises(ValueError, match="cuda_graphs"):
        StageEngine(create_stage_model(CFG, 0, 2), _params(),
                    EngineConfig(page_size=8, num_pages=16,
                                 kv_dtype="float32"),
                    device="cpu", cuda_graphs=True)


@pytest.mark.parametrize("free,want", [(64, 3), (3, 2), (2, 2), (1, 0)])
def test_plan_decode_window_sizes_chain_to_free_pages(free, want):
    """The chain is sized against the pages free now and its pages are
    reserved for every row; with too few pages for one window it returns 0
    (the caller then decodes one step)."""
    eng = _build_engine(4, num_pages=1 + 2 + free)
    sched = eng.scheduler
    a = _decoding("a", range(6), [1], sched.cache.allocator.alloc(1))
    b = _decoding("b", range(7), [], sched.cache.allocator.alloc(1))
    assert sched.cache.num_free_pages == free
    plan = BatchPlan([
        ScheduledSeq(a, 1, [a.all_token_ids[-1]], a.total_len),
        ScheduledSeq(b, 1, [b.all_token_ids[-1]], b.total_len),
    ])
    # Two rows at 7 tokens: one or two windows need one more page a row,
    # three need two.
    m = sched.plan_decode_window(plan, 4, max_windows=3, max_model_len=256)
    assert m == want
    if m:
        assert len(a.page_ids) * 8 >= a.total_len + m * 4
        assert len(b.page_ids) * 8 >= b.total_len + m * 4


def test_plan_decode_window_clamps_to_room_and_budget():
    eng = _build_engine(4)
    sched = eng.scheduler
    near = _decoding("n", range(20), [1], sched.cache.allocator.alloc(3))
    plan = BatchPlan([ScheduledSeq(near, 1, [1], near.total_len)])
    # Context room: (32 - 21) // 4 = 2 windows.
    assert sched.plan_decode_window(plan, 4, 8, max_model_len=32) == 2
    assert sched.plan_decode_window(plan, 4, 8, max_model_len=24) == 0
    # Budget: 20 - 1 generated = 19 tokens left -> 5 windows of 4.
    assert sched.plan_decode_window(plan, 4, 8, max_model_len=256) == 5
    # A device-fed row counts its in-flight token.
    fed = ScheduledSeq(near, 1, [0], near.total_len + 1, device_token=True)
    assert sched.plan_decode_window(BatchPlan([fed]), 6, 8,
                                    max_model_len=256) == 3


def test_fed_ahead_commit_does_not_rearm_the_row():
    eng = _build_engine(1)
    req = _decoding("r", range(5), [7], [])
    req.status = req.status.DECODING
    req.num_computed_tokens = req.total_len        # the token was fed
    eng.scheduler.on_token_committed(req)
    assert not req.ready_for_step
    req.num_computed_tokens = req.total_len - 1    # host-fed next
    req.device_feed_ready = True
    eng.scheduler.on_token_committed(req)
    assert req.ready_for_step and not req.device_feed_ready


def test_substitute_device_tokens_gathers_fed_rows():
    spec = BucketSpec.build(64, 8, 256, 8)
    a = _decoding("a", range(6), [3], [1])
    b = _decoding("b", range(9), [4], [2, 3])
    plan = BatchPlan([
        ScheduledSeq(a, 1, [0], a.total_len + 1, device_token=True),
        ScheduledSeq(b, 1, [4], b.total_len),
    ])
    staging = HostStaging("cpu")
    staging.begin()
    inputs = assemble(plan, spec, 8, "cpu", decode_only=True,
                      staging=staging)
    last = torch.tensor([11, 22, 33, 44], dtype=torch.int32)
    slots = torch.full((inputs.token_ids.shape[0],), -1, dtype=torch.int32)
    slots[0] = 2
    out = substitute_device_tokens(inputs, last, slots)
    assert out.token_ids[:2].tolist() == [33, 4]
    assert torch.equal(out.positions, inputs.positions)
