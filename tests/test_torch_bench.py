"""The port's benchmark harness (``tpu_path_tracer_torch.bench``) and the
kernel bounds it shares with ``chip_smoke.py`` (``utils.bounds``), on the
CPU.

Every workload runs small on the CPU, where its kernels take their plain
versions; its loss is held to the same loss built from the JAX package's
API, run op by op, at ``tests/test_torch_dist.py``'s tolerances.  The
parent (one process a workload, the line, the exit code) runs with stub
workloads in place of the children.  On the card the harness runs as
``python -m tpu_path_tracer_torch bench`` (``chip_smoke.py`` phase 19).
"""

import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_path_tracer as tpt
from tpu_path_tracer.core import rng as jrng
from tpu_path_tracer.diff import params as jparams
from tpu_path_tracer.integrator.render import path_trace_pixels as jptp

import chip_smoke
import tpu_path_tracer_torch as pt
from tpu_path_tracer_torch import bench, cli
from tpu_path_tracer_torch.kernels import _build
from tpu_path_tracer_torch.utils import bounds, profiling

import torch_dist_ranks as ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAD_RTOL = 2e-3    # tests/test_torch_dist.py
LOSS_RTOL = 1e-6
SMALL = dict(width=8, height=8, bounces=2, device="cpu")

# workload: (keyword arguments beside SMALL, bench.py's keys of its result)
FWD_BWD_KEYS = ("mrays", "step_ms", "spread_pct")
FWD_KEYS = ("mrays", "step_ms")
MESH_KEYS = ("mrays", "frame_ms", "mesh_gen_ms", "bvh_build_ms",
             "build_total_ms", "upload_ms", "tris")
WORKLOADS = {
    "fwd_bwd_megakernel": (dict(window=(1, 3)), FWD_BWD_KEYS),
    "fwd_bwd": (dict(window=(1, 3)), FWD_BWD_KEYS),
    "fwd_bwd_reference_scene": (dict(window=(1, 3)), FWD_BWD_KEYS),
    "fwd_bwd_mesh": (dict(window=(1, 3), subdivisions=1),
                     FWD_BWD_KEYS + ("tris",)),
    "fwd_wavefront": (dict(window=(1, 3)), FWD_KEYS),
    "fwd_pallas": (dict(window=(1, 3)), FWD_KEYS),
    "fwd_reference_scene": (dict(window=(1, 3)), FWD_KEYS),
    "mesh_bvh": (dict(window=(1, 3), subdivisions=1), MESH_KEYS),
    "mesh_bvh_327k": (dict(window=(1, 2)), MESH_KEYS),
    "mesh_bvh_327k_1024": (dict(window=(1, 2)), MESH_KEYS),
    "sol": (dict(window=(1, 3), trav_window=(1, 3), subdivisions=1),
            tuple(f"{p}_{k}" for p in ("fwd", "fwd_bwd", "trav")
                  for k in ("ms", "sol_us", "sol_frac", "bytes", "flops"))),
}


def _bench_py_extra_keys():
    """The keys of bench.py's line (bench.py:678-727), read from its
    source."""
    src = open(os.path.join(REPO, "bench.py")).read()
    start = src.index('"extra": {') + len('"extra": {')
    body = src[start:src.index('"errors": errors')]
    return set(re.findall(r'^\s*"(\w+)":', body, re.M)) | {"errors"}


# -------------------------------------------------------------- workloads


@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_workload_on_the_cpu(name):
    """Each workload at 8x8, 2 bounces on the CPU: bench.py's keys with
    finite positive values, its parity check passed, and no device time
    claimed for a CPU run.  ``sol`` counts the traversal's work with the
    kernel's walk built for the host by g++."""
    kw, keys = WORKLOADS[name]
    res = bench.WORKLOADS[name](**SMALL, **kw)
    for k in keys:
        assert np.isfinite(res[k]) and res[k] > 0, (k, res[k])
    device_ms = [v for k, v in res.items() if k.endswith("device_ms")]
    device_ms += [v for k, by_kernel in res.items()
                  if k.endswith("kernel_device_ms")
                  and isinstance(by_kernel, dict)
                  for v in by_kernel.values()]
    assert device_ms and all(v == "not measured" for v in device_ms
                             if not isinstance(v, dict))
    if name.startswith(("fwd_bwd_mega", "fwd_bwd_ref", "fwd_pallas",
                        "fwd_ref")):
        assert res["parity"]["share_within_tol"] == 1.0
        assert res["launches_per_step"]["megakernel_fwd"] == 0   # plain
    if name.startswith(("fwd_bwd_mesh", "mesh_bvh")):
        assert res["parity"]["same_index"] == 1.0
        assert res["parity"]["t_bit_equal"]
    if name.startswith("mesh_bvh_327k"):
        assert res["tris"] == 327680


def test_scaling_over_two_ranks():
    """``scaling`` on the CPU: two gloo ranks, measure_scaling's keys, the
    ranks and that they share the device."""
    res = bench.bench_scaling(width=8, height=8, bounces=2, device="cpu")
    assert res["ranks"] == res["devices"] == 2 and res["shares_device"]
    assert res["efficiency"] > 0 and "NOT a speedup" in res["kind"]


def test_mesh_monkey_without_its_asset_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(bench, "MONKEY_OBJ", str(tmp_path / "monkey.obj"))
    with pytest.raises(FileNotFoundError, match="monkey.obj"):
        bench.bench_mesh_monkey(**SMALL)


def test_mesh_monkey_scene_from_an_obj(tmp_path):
    """The monkey row's scene from an OBJ (``save_obj``'s icosphere):
    bench.py's room around the mesh scaled by 1.1."""
    from tpu_path_tracer_torch.scene.objreader import save_obj

    path = str(tmp_path / "m.obj")
    save_obj(path, pt.procedural.icosphere(1, 0.5))
    scene, meta = bench.monkey_scene("cpu", path)
    assert scene.triangles.count == 80 and scene.quads.count == 3
    radius = float(torch.linalg.norm(scene.triangles.a, dim=1).max())
    assert abs(radius - 0.55) < 1e-5
    assert meta.traversal == "bvh"


# ------------------------------------------------------ the loss against JAX


def _jax_loss(scene, meta, cfg, eye, groups):
    pix = jnp.arange(cfg.width * cfg.height, dtype=jnp.uint32)
    px = (pix % jnp.uint32(cfg.width)).astype(jnp.int32)
    py = (pix // jnp.uint32(cfg.width)).astype(jnp.int32)
    view = jnp.asarray(tpt.Camera(eye=list(eye), center=[0, 0, 0])
                       .view_matrix)
    target = jnp.zeros((pix.shape[0], 3), jnp.float32)

    def loss(params):   # bench.py:113-117
        s = jparams.apply_params(scene, params)
        _, radiance = jptp(jrng.seed(pix, jnp.int32(1)), view, px, py, s,
                           meta, cfg)
        return jnp.mean((radiance - target) ** 2)

    with jax.disable_jit():
        value, grads = jax.value_and_grad(loss)(
            jparams.extract_params(scene, groups))
    return float(value), {k: np.asarray(v) for k, v in grads.items()}


@pytest.mark.parametrize("case", ["cornell", "mesh"])
def test_first_step_loss_and_grads_match_jax(case):
    """The first step's loss and gradients of the Cornell emission + BSDF
    loss and of the mesh emission + vertices loss (the refit inside),
    through the wavefront, against bench.py's loss from the JAX package
    run op by op."""
    groups = {"cornell": ("emission", "bsdf"),
              "mesh": ("emission", "vertices")}[case]
    kw = dict(width=12, height=11, max_bounces=3, importance_sampling=True)
    if case == "cornell":
        scene, meta, _ = pt.builtin.cornell_box(device="cpu")
        jscene, jmeta, _ = tpt.builtin.cornell_box()
    else:
        scene, meta = bench.mesh_scene(2, "cpu")
        jscene, jmeta = ranks.mirror_sphere_scene(tpt)
    loss, params = bench.fwd_bwd_loss(scene, meta, pt.RenderConfig(**kw),
                                      bench.EYE, groups, "cpu")
    leaves = {k: v.requires_grad_(True) for k, v in params.items()}
    value = loss(leaves, 1)
    grads = dict(zip(leaves, torch.autograd.grad(value,
                                                 list(leaves.values()))))
    jvalue, jgrads = _jax_loss(jscene, jmeta,
                               tpt.RenderConfig(**kw, use_pallas=False),
                               bench.EYE, groups)
    assert abs(float(value.detach()) - jvalue) <= LOSS_RTOL * jvalue
    assert sorted(grads) == sorted(jgrads)
    for k, g in grads.items():
        scale = max(float(np.abs(jgrads[k]).max()), 1e-6)
        np.testing.assert_allclose(g.numpy(), jgrads[k], rtol=0,
                                   atol=GRAD_RTOL * scale, err_msg=k)
    assert any(np.abs(g).max() > 0 for g in jgrads.values())


def test_train_step_chains_the_backward():
    """bench.py:126-133's step: the parameters move by 1e-18 of their
    gradient and the frame number advances."""
    scene, meta, _ = pt.builtin.cornell_box(device="cpu")
    cfg = pt.RenderConfig(width=8, height=8, max_bounces=2)
    loss, params = bench.fwd_bwd_loss(scene, meta, cfg, bench.EYE,
                                      ("emission",), "cpu")
    leaves = {"emission": params["emission"].clone().requires_grad_(True)}
    g, = torch.autograd.grad(loss(leaves, 1), [leaves["emission"]])
    (after, frame) = bench._train_step(loss)((params, 1))
    assert frame == 2 and not after["emission"].requires_grad
    torch.testing.assert_close(after["emission"],
                               params["emission"] - 1e-18 * g, rtol=0,
                               atol=0)


# ---------------------------------------------------------------- parent


def _stub_spawn(name, device):
    """A child run in this process, read back through the line a child
    prints."""
    payload = bench.run_workload(name, device)
    return bench.parse_child(0, "BENCH_RESULT " + json.dumps(payload), "")


def _ok(step_ms):
    return lambda device: {"mrays": 1.0, "step_ms": step_ms,
                           "spread_pct": 1.0, "device_ms": 0.5,
                           "kernel_device_ms": {}, "launches_per_step": {}}


def _fails(device):
    raise RuntimeError("the kernel disagrees")


def _parent(monkeypatch, tmp_path, capsys, workloads, argv=("--device",
                                                            "cpu")):
    monkeypatch.setattr(bench, "WORKLOADS", workloads)
    monkeypatch.setattr(bench, "_spawn", _stub_spawn)
    monkeypatch.setattr(bench, "MONKEY_OBJ", str(tmp_path / "absent.obj"))
    code = bench.main(list(argv))
    out = capsys.readouterr().out.strip().splitlines()
    return code, json.loads(out[-1])


def test_parent_reports_failures_and_skips(monkeypatch, tmp_path, capsys):
    """One row passes, one raises, the monkey's asset is absent: bench.py's
    keys (the scaling key renamed), null and the error for the failed row,
    the monkey under ``skipped`` with its path, and a non-zero exit."""
    code, line = _parent(monkeypatch, tmp_path, capsys, {
        "fwd_bwd_megakernel": _ok(4.0), "fwd_pallas": _fails,
        "mesh_monkey": _ok(1.0)})
    extra = line["extra"]
    want = (_bench_py_extra_keys() - {"scaling_efficiency_8dev"}
            | {"scaling_efficiency", "scaling_ranks",
               "scaling_shares_device", "card", "workload_rev", "skipped"})
    assert want <= set(extra), want - set(extra)
    assert code == 1
    assert extra["fwd_pallas_megakernel_mrays"] is None
    assert extra["errors"] == {
        "fwd_pallas": "RuntimeError: the kernel disagrees"}
    assert str(tmp_path / "absent.obj") in extra["skipped"]["mesh_monkey"]
    assert line["value"] == extra["fwd_bwd_megakernel_mrays"] == 1.0
    assert extra["fwd_bwd_megakernel_device_ms"] == 0.5
    assert extra["workload_rev"] == bench.WORKLOAD_REV
    assert extra["device"] == "cpu" and extra["card"] is None


def test_parent_exits_zero_with_only_the_skip(monkeypatch, tmp_path,
                                              capsys):
    code, line = _parent(monkeypatch, tmp_path, capsys, {
        "fwd_bwd_megakernel": _ok(4.0), "mesh_monkey": _ok(1.0)})
    assert code == 0
    assert line["extra"]["errors"] is None
    assert list(line["extra"]["skipped"]) == ["mesh_monkey"]
    assert line["vs_baseline"] == 1.0 / bench.BASELINE_MRAYS


def test_headline_never_falls_back_to_the_wavefront(monkeypatch, tmp_path,
                                                    capsys):
    """The megakernel row failed and the wavefront's passed: the headline
    is null (bench.py:668-670 would report the wavefront's number)."""
    code, line = _parent(monkeypatch, tmp_path, capsys, {
        "fwd_bwd_megakernel": _fails, "fwd_bwd": _ok(600.0)})
    assert code == 1
    assert line["value"] is None and line["vs_baseline"] is None
    assert line["extra"]["fwd_bwd_wavefront_mrays"] == 1.0


def test_sanity_gate_measures_again_and_keeps_the_slower(monkeypatch,
                                                         tmp_path, capsys):
    """fwd+bwd under 1.5x the forward megakernel trips bench.py's gate:
    the row is measured once more and the slower run kept."""
    times = iter([1.0, 3.0])
    code, line = _parent(monkeypatch, tmp_path, capsys, {
        "fwd_bwd_megakernel": lambda device: _ok(next(times))(device),
        "fwd_pallas": _ok(1.0)})
    assert code == 0
    assert line["extra"]["headline_sanity_gated"] is True
    assert line["extra"]["fwd_bwd_megakernel_ms"] == 3.0


def test_parse_child():
    ok = bench.parse_child(0, 'x\nBENCH_RESULT {"ok": true, "result": '
                           '{"mrays": 2.0}}\n', "")
    assert ok == ({"mrays": 2.0}, None)
    failed = bench.parse_child(1, 'BENCH_RESULT {"ok": false, "error": '
                               '"ValueError: no"}', "")
    assert failed == (None, "ValueError: no")
    res, err = bench.parse_child(-11, "", "a\nb\nSegmentation fault")
    assert res is None and "rc=-11" in err and "Segmentation" in err


def test_cli_bench_reaches_the_harness(monkeypatch, tmp_path, capsys):
    """``cli.main(["bench", "--device", "cpu"])`` runs the harness and
    exits with its code."""
    monkeypatch.setattr(bench, "WORKLOADS",
                        {"fwd_bwd_megakernel": _ok(4.0)})
    monkeypatch.setattr(bench, "_spawn", _stub_spawn)
    with pytest.raises(SystemExit) as exc:
        cli.main(["bench", "--device", "cpu"])
    assert exc.value.code == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["value"] == 1.0 and line["unit"] == "Mray/s"


def test_bench_without_a_card_raises(monkeypatch):
    """On the card by default: without one the harness raises, naming
    --device cpu, before any workload starts."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(bench, "_spawn", None)
    with pytest.raises(RuntimeError, match="--device cpu"):
        bench.main([])


# ---------------------------------------------------------------- bounds

# The counts chip_smoke.py's bound functions gave on these inputs before
# they moved into utils.bounds (8x8, 2 bounces, frame 1, on the CPU).
BOUNDS_BEFORE = {
    ("cornell", False): (104, 352, 0, 0, 62256, 2468),
    ("cornell", True): (104, 352, 0, 0, 186768, 4168),
    ("reference", False): (128, 512, 6, 4, 204470, 5344),
    ("reference", True): (128, 512, 6, 4, 613410, 9920),
}


@pytest.mark.parametrize("scene_name, backward", sorted(BOUNDS_BEFORE))
def test_megakernel_bound_counts_as_before(scene_name, backward):
    eye, kw = ([0, 0, 3.2], dict(importance_sampling=True)) if (
        scene_name == "cornell") else ([0.5, 0, 2.5], {})
    make = getattr(pt.builtin, {"cornell": "cornell_box",
                                "reference": "reference_scene"}[scene_name])
    scene, meta, _ = make(device="cpu")
    b = bounds.megakernel_bound(scene, meta, pt.RenderConfig(
        width=8, height=8, max_bounces=2, **kw), eye, backward=backward)
    assert (b["lane_bounces"], b["facing_quads"], b["spans"], b["events"],
            b["flops"], b["bytes"]) == BOUNDS_BEFORE[scene_name, backward]
    assert b["bound_by"] == "operations"
    assert b["bound_ms"] == b["flops"] / bounds.PEAK_FP32_FLOPS * 1e3


def test_traversal_bound_counts_as_before():
    """The arithmetic on fixed work, and the work of the kernel's walk
    (its host build) on bench.py's mesh scene at subdivision 2."""
    assert bounds.traversal_bound(1024, 77, 320, {
        "rows": 12345, "tri_tests": 678}) == {
        "bound_ms": 1.7060298507462688e-05, "bound_by": "bytes",
        "flops": 811317, "bytes": 57152}
    assert bounds.pack_bound(100, 77, 320) == {
        "bound_ms": 1.1405373134328359e-05, "bound_by": "bytes"}
    from tpu_path_tracer_torch.kernels import traversal

    scene, meta = bench.mesh_scene(2, "cpu")
    o, d, t0 = (torch.from_numpy(x) for x in chip_smoke.traversal_rays(
        1024, 2, 0.8, scene.triangles.a.numpy()))
    rows, tri_rows = traversal.pack_bvh(scene.bvh, scene.triangles)
    t, i, n_rows, n_tests = bounds.counted_walk(
        rows, tri_rows, o, d, t0, 1e-4, _build.load_host_walk())
    assert (n_rows, n_tests) == (9595, 1269)
    t_p, i_p = traversal.bvh_closest_hit(o, d, scene.bvh, scene.triangles,
                                         1e-4, t0, meta.max_leaf)
    np.testing.assert_array_equal(i, i_p.numpy())
    np.testing.assert_array_equal(t, t_p.numpy())


def test_megakernel_bound_counts_the_bvh_walks():
    """Where the forward walks the scene's BVH (bench.py's mesh scene at
    subdivision 2, 320 triangles), its bound counts the walks the
    wavefront's frame makes, by the kernel's walk built for the host, in
    place of a test of every triangle, and reads the BVH's rows once."""
    from tpu_path_tracer_torch.kernels import megakernel as mk
    from tpu_path_tracer_torch.kernels import traversal

    scene, meta = bench.mesh_scene(2, "cpu")
    cfg = pt.RenderConfig(width=8, height=8, max_bounces=2,
                          importance_sampling=True)
    assert mk.route(scene, meta, cfg.replace(use_megakernel=True),
                    torch.eye(4), torch.device("cpu")).tracer == mk.BVH
    calls = []
    closest_hit = traversal.closest_hit

    def recorded(*args):
        calls.append(args)
        return closest_hit(*args)

    traversal.closest_hit = recorded
    try:
        b = bounds.megakernel_bound(scene, meta, cfg, [0, 0, 3.2],
                                    backward=False)
    finally:
        traversal.closest_hit = closest_hit
    assert len(calls) == cfg.max_bounces
    rows, tri_rows = traversal.pack_bvh(scene.bvh, scene.triangles)
    lib = _build.load_host_walk()
    walks = [bounds.counted_walk(rows, tri_rows, o, d, t0, t_min, lib)[2:]
             for o, d, _, _, t_min, t0 in calls]
    assert (b["walk_rows"], b["walk_tri_tests"]) == tuple(map(sum,
                                                              zip(*walks)))
    assert b["walk_rows"] > 0 and b["walk_tri_tests"] > 0
    per_bounce = (bounds.RAY_FLOPS + 3 * bounds.QUAD_CULL_FLOPS
                  + bounds.SHADE_FLOPS + bounds.NEE_FLOPS)
    assert scene.quads.count == 3 and scene.spheres.count == 0
    assert b["flops"] == (b["lane_bounces"] * per_bounce
                          + b["facing_quads"] * bounds.QUAD_FLOPS
                          + b["walk_rows"] * bounds.ROW_FLOPS
                          + b["walk_tri_tests"] * bounds.MT_PRE_FLOPS)
    tables = 4 * sum(t.numel() for t in mk.pack_tables(scene)) + 64
    assert b["bytes"] == (64 * 24 + tables + 64 * rows.shape[0]
                          + 48 * scene.triangles.count)


def test_one_count_serves_both_scripts():
    """chip_smoke.py's bounds and profile helpers are the package's."""
    for name in ("bound", "megakernel_bound", "traversal_bound",
                 "pack_bound", "counted_walk", "PEAK_FP32_FLOPS"):
        assert getattr(chip_smoke, name) is getattr(bounds, name), name
    assert chip_smoke.profile_device_ms is profiling.profile_device_ms
    assert chip_smoke.mesh_scene is bench.mesh_scene
    assert chip_smoke.KERNEL_TOL is bench.KERNEL_TOL


def test_profile_device_ms_on_the_cpu():
    """No device time from a CPU run: every group reads "not measured"."""
    calls = []
    ms, rows = profiling.profile_device_ms(lambda: calls.append(1), 2,
                                           {"k": ["kernel"]})
    assert ms == {"k": "not measured", "all": "not measured"}
    assert rows == [] and len(calls) == 3
