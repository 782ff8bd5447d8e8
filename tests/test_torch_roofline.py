"""The port's roofline tooling: the analytic cost model, the collective
recorder, the roofline terms and the dry-run, on the CPU.

(a) ``repro_torch.utils.flops``' ``cell_cost`` and
    ``fwd_flops_per_token`` equal the reference's ``repro.utils.flops``
    on all 33 (arch, shape) cells at both production meshes (256 and 512
    chips, 16-way 'model', the reference's baseline microbatching).
(b) The roofline's terms and dominance at the H100 SXM's peaks, and the
    link a group is held to (NVLink inside an 8-card node, the NIC
    across nodes).
(c) The recorder: five sharded contractions in a Python loop issue five
    all-reduces, each of its result's bytes (eager PyTorch runs every
    trip: the counterpart of the reference's loop-trip parser test).
(d) The analytic forward FLOPs within 20% of ``FlopCounterMode`` on a
    one-layer config without loops.
(e) ``dryrun.run_cell`` on the real 16 x 16 and 2 x 16 x 16 fake groups,
    one cell per step kind, for gemma2-2b, olmoe-1b-7b and
    falcon-mamba-7b at their smoke configs (and long_500k, batch 1, for
    the two that serve it), with the shapes cut as the reference's CI
    test cuts them, adapted to the production mesh: every sequence
    longer than 512 cut to 512, and every batch larger than the data
    ranks (16 on 16 x 16, 32 on 2 x 16 x 16) cut to their count (the
    reference's CI cut to 8 is for its 2 data ranks); each gives a full
    record, and long_500k's decode shards its cache's sequence.

The fake process group lives in this process for the module's tests
that need it and is destroyed at the module's end.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as ref_config  # noqa: E402
from repro.configs.shapes import SHAPES as REF_SHAPES  # noqa: E402
from repro.utils import flops as ref_flops  # noqa: E402
from repro_torch.configs import (ARCHS, get_config,  # noqa: E402
                                 get_smoke_config)
from repro_torch.configs.shapes import SHAPES, applicable_shapes  # noqa: E402
from repro_torch.utils import flops  # noqa: E402
from repro_torch.utils import roofline as R  # noqa: E402

MESHES = {"pod": (256, 16), "multipod": (512, 16)}
CELLS = [(a, s) for a in ARCHS for s in applicable_shapes(a)]


def test_thirty_three_cells():
    assert len(CELLS) == 33


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cell_cost_equals_reference(arch, mesh):
    chips, model = MESHES[mesh]
    cfg, rcfg = get_config(arch), ref_config(arch)
    for s in applicable_shapes(arch):
        shape, rshape = SHAPES[s], REF_SHAPES[s]
        accum = max(shape.global_batch // (chips // model) // 2, 1) \
            if shape.kind == "train" else 1
        for window_cache in (False, True):
            got = flops.cell_cost(cfg, shape, chips, model, accum,
                                  window_cache=window_cache)
            want = ref_flops.cell_cost(rcfg, rshape, chips, model, accum,
                                       window_cache=window_cache)
            assert dataclasses.astuple(got) == dataclasses.astuple(want), s
        assert flops.fwd_flops_per_token(cfg, shape.seq_len) == \
            ref_flops.fwd_flops_per_token(rcfg, rshape.seq_len)
        assert flops.fwd_flops_per_token(cfg, shape.seq_len,
                                         decode_ctx=shape.seq_len) == \
            ref_flops.fwd_flops_per_token(rcfg, rshape.seq_len,
                                          decode_ctx=rshape.seq_len)


def test_roofline_terms_and_dominance():
    r = R.Roofline(flops=989e12, hbm_bytes=3.35e12 / 2, wire_bytes=50e9 * 2,
                   model_flops=989e12 * 256 * 0.5, chips=256)
    assert abs(r.compute_s - 1.0) < 1e-9
    assert abs(r.memory_s - 0.5) < 1e-9
    assert abs(r.collective_s - 2.0) < 1e-9
    assert r.dominant == "collective"
    assert 0 < r.mfu_bound <= 1.0
    assert R.link_bw(8) == R.NVLINK_BW == 450e9
    assert R.link_bw(16) == R.NIC_BW == 50e9
    inside = R.Roofline(flops=0.0, hbm_bytes=0.0, wire_bytes=450e9,
                        model_flops=0.0, chips=8, link_bw=R.link_bw(8))
    assert abs(inside.collective_s - 1.0) < 1e-9
    d = r.to_dict()
    assert d["dominant"] == "collective" and "H100" in d["card"]


@pytest.fixture(scope="module")
def fake_world():
    """A fake process group in this process, destroyed afterwards."""
    import torch.distributed as dist

    from repro_torch.launch import dryrun

    yield dryrun.ensure_world
    if dist.is_initialized():
        dist.destroy_process_group()


def test_recorder_counts_every_loop_trip(fake_world):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    fake_world(4)
    mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("model",))
    x = distribute_tensor(torch.ones(8, 64), mesh, [Shard(1)],
                          src_data_rank=None)
    w = distribute_tensor(torch.ones(64, 32), mesh, [Shard(0)],
                          src_data_rank=None)
    rec = R.CollectiveRecorder()
    with rec:
        for _ in range(5):     # each contraction over the sharded dim
            y = (x @ w).redistribute(mesh, [Replicate()])
    assert rec.stats.counts == {"all-reduce": 5}
    assert rec.stats.bytes_by_kind == {"all-reduce": 5 * 8 * 32 * 4}
    assert rec.stats.total_wire_bytes == 2 * 5 * 8 * 32 * 4
    assert y.shape == (8, 32)


def test_analytic_flops_match_flop_counter_on_unlooped_config():
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.models import lm
    from repro_torch.models.config import ModelConfig

    cfg = ModelConfig(arch_id="tiny", family="dense", n_layers=1,
                      d_model=256, n_heads=4, n_kv_heads=4, d_ff=1024,
                      vocab_size=512, param_dtype="float32")
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.zeros((2, 128), dtype=torch.int64)
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        x, _ = lm.forward_train(params, tokens, cfg, remat=False)
        lm.logits_for(params, x, cfg).sum()
    counted = counter.get_total_flops()
    analytic = flops.fwd_flops_per_token(cfg, 128) * 2 * 128
    assert abs(analytic - counted) / counted < 0.20, (analytic, counted)


def _cut(shape, data_ranks):
    """Sequences to 512, batches to the data ranks' count."""
    return dataclasses.replace(shape, seq_len=min(shape.seq_len, 512),
                               global_batch=min(shape.global_batch,
                                                data_ranks))


KEYS = ("arch", "shape", "mesh", "chips", "kind", "trace_s",
        "torch_flops_raw", "argument_bytes_per_chip", "collective_counts",
        "collective_bytes_by_kind", "wire_bytes_per_chip", "flops_per_chip",
        "hbm_bytes_per_chip", "roofline")


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", ["gemma2-2b", "olmoe-1b-7b",
                                  "falcon-mamba-7b"])
def test_dryrun_cells_on_production_mesh(fake_world, tmp_path, arch,
                                         multi_pod):
    from repro_torch.launch import dryrun

    for name in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
        if name not in applicable_shapes(arch):
            continue
        shape = _cut(SHAPES[name], 32 if multi_pod else 16)
        rec = dryrun.run_cell(arch, name, multi_pod, str(tmp_path),
                              cfg=get_smoke_config(arch), shape=shape)
        assert all(k in rec for k in KEYS), sorted(rec)
        assert rec["mesh"] == ([2, 16, 16] if multi_pod else [16, 16])
        assert rec["chips"] == (512 if multi_pod else 256)
        assert rec["kind"] == shape.kind
        assert rec["flops_per_chip"] > 0 and rec["hbm_bytes_per_chip"] > 0
        assert rec["torch_flops_raw"] > 0
        assert rec["argument_bytes_per_chip"] > 0
        assert rec["roofline"]["dominant"] in ("compute", "memory",
                                               "collective")
        if shape.kind == "train":
            assert rec["grad_accum"] == 1
            assert rec["collective_counts"].get("all-reduce", 0) > 0
        if shape.kind == "decode":
            assert rec["shard_seq"] is (name == "long_500k")
        assert (tmp_path / f"{arch}__{name}__"
                f"{'multipod' if multi_pod else 'pod'}.json").exists()
