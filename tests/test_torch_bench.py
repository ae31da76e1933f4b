"""bench_torch.py, the port's benchmark, on the CPU at toy size. Mirrors
tests/test_tools.py::test_bench_tally_gate_and_sized_runner_wiring: the
tally gate of both benchmarks gets the same JAX keys and α, and must give
the same four outputs; the sized runner's wiring; and a whole toy run of
bench_torch.run whose JSON line carries every key of bench.py's line."""

import ast
import dataclasses
import json
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import bench_torch  # noqa: E402
import objective_slam_tpu as ost  # noqa: E402
import objective_slam_tpu_torch as pt  # noqa: E402
from objective_slam_tpu.config import PPFConfig  # noqa: E402
from objective_slam_tpu.models import drost as jdrost  # noqa: E402
from objective_slam_tpu.ops import ppf as jppf  # noqa: E402
from objective_slam_tpu.ops import voting_block as jvb  # noqa: E402
from objective_slam_tpu.ops import voting_fast as jvf  # noqa: E402
from objective_slam_tpu.utils import pointcloud as jpc  # noqa: E402
from objective_slam_tpu.utils import synthetic  # noqa: E402
from objective_slam_tpu_torch.ops import voting as tvoting  # noqa: E402
from objective_slam_tpu_torch.ops import voting_fast as tvf  # noqa: E402
from objective_slam_tpu_torch.utils import pointcloud as tpc  # noqa: E402


def _t(x):
    return torch.from_numpy(np.array(x))


def _bench_line_keys():
    """The keys of the JSON line bench.py prints (bench.py:527-569),
    nested ones as "outer.inner", read from its source."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    dumps = [n for n in ast.walk(main) if isinstance(n, ast.Call)
             and getattr(n.func, "attr", None) == "dumps"]
    keys = set()

    def walk(d, prefix):
        for k, v in zip(d.keys, d.values):
            keys.add(prefix + k.value)
            if isinstance(v, ast.Dict):
                walk(v, prefix + k.value + ".")
    walk(dumps[-1].args[0], "")
    # per_seed rows: the dict appended to `matches`.
    row = next(n.args[0] for n in ast.walk(main) if isinstance(n, ast.Call)
               and getattr(n.func, "attr", None) == "append"
               and isinstance(n.args[0], ast.Dict))
    walk(row, "extra.per_seed.")
    return keys


def _line_keys(line):
    keys = set()

    def walk(d, prefix):
        for k, v in d.items():
            keys.add(prefix + k)
            if isinstance(v, dict):
                walk(v, prefix + k + ".")
    walk(line, "")
    walk(line["extra"]["per_seed"][0], "extra.per_seed.")
    return keys


@pytest.fixture(scope="module")
def gate_inputs():
    """The JAX test's toy scene (test_tools.py:106-137): a planted copy of
    a 1,200-point blob, its description in both packages, the JAX keys and
    the caps."""
    rng = np.random.default_rng(0)
    mp_raw, mn_raw = synthetic.blob_cloud(rng, 1200)
    sp, sn, _T = synthetic.plant_model(rng, mp_raw[::3], mn_raw[::3])
    cfg = PPFConfig(engine="correlation", ref_point_df=10, max_poses=64,
                    refine_icp=False)
    d_dist = cfg.tau_d * jpc.bbox_diameter(mp_raw)
    mp, mn = jpc.voxel_downsample_np(mp_raw, mn_raw, d_dist)
    jdesc = ost.build_model_description(mp, mn, cfg, d_dist=d_dist)
    tcfg = pt.PPFConfig(engine="correlation", ref_point_df=10, max_poses=64,
                        refine_icp=False)
    tdesc = pt.build_model_description(mp, mn, tcfg, d_dist=d_dist,
                                       device="cpu")
    # The port's key table is the JAX package's, array for array: the two
    # packages' α_m differ by ulps (arctan2), and the readable engine's
    # float32 binning would show them as flips.
    table = tvoting.KeyTable(*[_t(x) for x in jdesc.table])
    tdesc = dataclasses.replace(
        tdesc, table=table, fast_tables=tvf.build_fast_tables(table))
    assert tdesc.fast_tables.block is not None

    capacity = 512
    vox = jpc.voxel_downsample(sp, sn, d_dist, capacity=capacity)
    assert not bool(vox.dropped)
    total, rows, segs = jdrost._count_votes(
        jdesc, vox.points, vox.normals, cfg.ref_point_df, cfg.d_angle)
    n_ref = (capacity + cfg.ref_point_df - 1) // cfg.ref_point_df
    caps = (jdrost._next_cap((rows + jvb.CHUNK_ROWS * n_ref) * 128),
            jdrost._next_cap(max(segs, 1024)),
            jdrost._next_cap(total + jvf.TALLY_CHUNK * n_ref),
            jdrost._next_cap(total))
    ref_idx = jnp.arange(0, capacity, cfg.ref_point_df, dtype=jnp.int32)
    keys, alpha = jppf.pairwise_ppf_keys(
        vox.points, vox.normals, jdesc.d_dist, cfg.d_angle,
        jdesc.max_dist_bin, ref_indices=ref_idx)
    return dict(sp=sp, sn=sn, d_dist=d_dist, capacity=capacity, cfg=cfg,
                jdesc=jdesc, tdesc=tdesc, keys=keys, alpha=alpha, caps=caps,
                total=total)


def test_tally_gate_equals_bench_py_on_the_same_keys(gate_inputs):
    import bench

    g = gate_inputs
    want = bench.tally_bitequal_check(g["keys"], g["alpha"], g["jdesc"],
                                      g["cfg"].d_angle, *g["caps"])
    want = (bool(want[0]), bool(want[1]), int(want[2]), bool(want[3]))
    got = bench_torch.tally_bitequal_check(_t(g["keys"]), _t(g["alpha"]),
                                           g["tdesc"],
                                           g["cfg"].d_angle, *g["caps"])
    print(f"gate: bench.py {want}, bench_torch {got}, "
          f"{g['total']} votes")
    assert got == want
    assert got[0] and got[1] and not got[3]
    assert got[2] / g["total"] < 1e-4


def test_sized_runner_wiring(gate_inputs):
    g = gate_inputs
    cfg_fast = pt.PPFConfig(engine="fast", ref_point_df=10, max_poses=64,
                            refine_icp=False)

    def vox_fn(p, n):
        return tpc.voxel_downsample(p, n, g["d_dist"],
                                    capacity=g["capacity"])

    run_sized = bench_torch.make_sized_runner(g["tdesc"], cfg_fast, vox_fn)
    res = run_sized(torch.from_numpy(g["sp"]), torch.from_numpy(g["sn"]))
    assert tuple(res.pose.shape) == (4, 4)
    assert bool(torch.isfinite(res.pose).all())
    assert not bool(res.overflowed)
    assert int(res.num_votes) > 0


def test_toy_run_prints_every_bench_py_key(tmp_path):
    torch.manual_seed(0)
    line, ctx = bench_torch.run("cpu", n_seeds=1, reps=1, n_total=1600,
                                n_model_raw=800, trace_dir=str(tmp_path))
    text = json.dumps(line)
    assert json.loads(text) == line
    missing = _bench_line_keys() - {"extra.e2e_target_ms"} - _line_keys(line)
    assert not missing, missing
    extra = line["extra"]
    # Beside each timed figure: its spread and its device time, which a
    # CPU run does not measure.
    timed = ["e2e_pose_ms_100k_scene", "e2e_with_sizing_ms",
             "e2e_corr_pose_ms", "exact_engine_voting_ms",
             "correlation_voting_ms"]
    for name, d in [(n, extra) for n in timed] + [
            ("normals_ms", extra["est_normals"]),
            ("e2e_ms", extra["est_normals"])]:
        lo, hi = d[f"{name}_spread"]
        assert lo <= d[name] <= hi
        assert d[f"{name}_device_ms"] is None
    assert extra["device"] == "cpu"
    # One traced fixed-caps repetition (BENCH_TRACE_DIR): a chrome trace;
    # a CPU run traces no kernel.
    assert Path(extra["trace"]["path"]).exists()
    assert extra["trace"]["kernel_ms"] == 0.0
    assert extra["tally_bitequal_on_device"]
    assert extra["readable_engine_flip_rate"] < 1e-4
    assert not extra["overflowed"]
    assert extra["num_votes"] == ctx["totals"][0] > 0
    assert extra["per_seed"][0]["num_votes"] == extra["num_votes"]
    assert extra["pose_match"] and extra["pose_match_corr"]
    assert extra["instances_planted"] == 4


def test_main_refuses_to_run_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_torch.main()
