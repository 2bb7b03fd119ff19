"""The port's multi-process runs (``satellite_approximation_tpu_torch/parallel/multihost.py``
and the process-spanning mesh of ``parallel/``) on the CPU: real worker
processes joined by gloo over loopback.

Contracts: the port's ``dcn_dryrun`` certifies what the JAX package's does
(1e-6, iterations +-1); a mesh that spans two processes gives x, iterations
and every collective bit-equal to a mesh of the same shape inside one
process, run on one thread as the workers are (tests/multihost_workers.py
is the worker and computes both sides), and x within 1e-5 of the JAX
package's in-process ``sharded_mg_solve``; a failing worker takes the run
down with its output and leaves no process behind; the backend policy;
and the functions without a cross-process form refuse such a mesh by name.
"""

import contextlib
import os
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from satellite_approximation_tpu.parallel import mesh as j_mesh
from satellite_approximation_tpu.parallel import mg as j_mg
from satellite_approximation_tpu.parallel.multihost import dcn_dryrun as jax_dcn_dryrun
from satellite_approximation_tpu_torch.parallel import dcn_dryrun
from satellite_approximation_tpu_torch.parallel import mesh as t_mesh
from satellite_approximation_tpu_torch.parallel.multihost import free_port, run_processes

import multihost_workers as W

WORKERS = str(Path(W.__file__).resolve())
STEP_TIMEOUT = 120.0  # each worker run; the tier-1 run allows far more


@contextlib.contextmanager
def one_thread():
    """torch on one CPU thread, as the workers run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _children() -> set[int]:
    """Live child processes of this one (Linux /proc)."""
    me, out = os.getpid(), set()
    for d in Path("/proc").iterdir():
        if d.name.isdigit():
            try:
                fields = (d / "stat").read_text().rsplit(")", 1)[1].split()
            except OSError:
                continue
            if int(fields[1]) == me and fields[0] != "Z":
                out.add(int(d.name))
    return out


def _run(case, shape, tmp_path, n_processes=2) -> list[dict]:
    coordinator = f"127.0.0.1:{free_port()}"
    run_processes([[WORKERS, case, "--coordinator", coordinator,
                    "--num-processes", str(n_processes), "--process-id", str(p),
                    "--shape", *map(str, shape), "--out", str(tmp_path)]
                   for p in range(n_processes)], timeout_s=STEP_TIMEOUT)
    return [dict(np.load(tmp_path / f"{case}_{p}.npz")) for p in range(n_processes)]


def _one_process_mesh(shape):
    return t_mesh.ShardMesh(shape, W.AXES[len(shape)], ["cpu"] * int(np.prod(shape)))


# ------------------------------------------------------------------ (a) the dry run


def test_dcn_dryrun_matches_jax():
    want = jax_dcn_dryrun(2, 4, 256)
    got = dcn_dryrun(2, 4, 256, device="cpu", timeout_s=STEP_TIMEOUT)
    for out in (want, got):
        assert out["ok"] and out["process_count"] == 2 and out["devices"] == 8
        assert out["rel_residual"] <= 1e-6
    assert abs(got["iterations"] - want["iterations"]) <= 1
    assert got["backend"] == "gloo"
    assert [p["devices"] for p in got["processes"]] == [["cpu"] * 4] * 2
    assert not any(p["jax_imported"] for p in got["processes"])


def test_dcn_dryrun_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dcn_dryrun()


# ------------------------------------------------------------------ (b) the solve


@pytest.mark.parametrize("shape", [(1, 4), (2, 2), (1, 2, 2)], ids=["1x4", "2x2", "1x2x2"])
def test_two_processes_bit_equal_to_one(shape, tmp_path):
    """x and iterations bit-equal to one process; on (2, 2) the band axis
    crosses the processes; (1, 2, 2) is the 2-D solve."""
    outs = _run("solve", shape, tmp_path)
    assert "x" in outs[0] and "x" not in outs[1]
    with one_thread():
        want = W.solve(_one_process_mesh(shape), shape)
    assert str(outs[0]["backend"]) == "gloo"
    for out in outs:
        assert int(out["iterations"]) == int(want["iterations"]) > 0
        np.testing.assert_array_equal(out["rel"], want["rel"])
    assert np.all(outs[0]["rel"] <= 1e-6)
    np.testing.assert_array_equal(outs[0]["x"], want["x"])

    b, umask = W.solve_inputs(shape)
    if len(shape) == 3:
        jm = j_mesh.spatial_mesh_2d(4, shape=shape)
        xj, itj, _ = j_mg.sharded_mg_solve_2d(b, np.zeros_like(b), umask, None, jm, tolerance=1e-6)
    else:
        jm = j_mesh.spatial_band_mesh(4, shape=shape)
        xj, itj, _ = j_mg.sharded_mg_solve(b, np.zeros_like(b), umask, None, jm, tolerance=1e-6)
    np.testing.assert_allclose(outs[0]["x"], np.asarray(xj), rtol=0, atol=1e-5)
    assert abs(int(outs[0]["iterations"]) - int(itj)) <= 1


# ------------------------------------------------------------------ (c) the collectives


@pytest.fixture(scope="module")
def collectives_run(tmp_path_factory):
    shape = (1, 4)
    outs = _run("collectives", shape, tmp_path_factory.mktemp("collectives"))
    want = W.collectives(_one_process_mesh(shape))
    return outs, want


@pytest.mark.parametrize("kind", ["rows", "cols"])
@pytest.mark.parametrize("depth,boundary", W.HALO_CASES)
def test_halo_across_processes_bit_equal(collectives_run, kind, depth, boundary):
    outs, want = collectives_run
    name = f"{kind}_{depth}_{boundary:g}"
    got = {k: v for out in outs for k, v in out.items() if k.startswith(name + "/")}
    assert sorted(got) == sorted(k for k in want if k.startswith(name + "/")) and len(got) == 4
    for k, v in got.items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)


@pytest.mark.parametrize("name", ["psum", "pmax"])
def test_reductions_across_processes_bit_equal(collectives_run, name):
    outs, want = collectives_run
    got = {k: v for out in outs for k, v in out.items() if k.startswith(name + "/")}
    assert len(got) == 4
    for k, v in got.items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)


def test_any_true_and_gather_across_processes(collectives_run):
    outs, want = collectives_run
    assert list(want["any_true"]) == [True, False, True, True]
    for out in outs:
        np.testing.assert_array_equal(out["any_true"], want["any_true"])
        np.testing.assert_array_equal(out["gather_all"], want["gather_all"])
    np.testing.assert_array_equal(outs[0]["gather_root"], want["gather_root"])
    np.testing.assert_array_equal(want["gather_all"], W.collective_inputs())
    assert "gather_root" not in outs[1]


# ------------------------------------------------------------------ (d) failures


def test_failing_worker_raises_with_its_output_and_kills_the_rest(tmp_path):
    pidfile = tmp_path / "sleeper.pid"
    sleeper = (f"import os, time\nopen({str(pidfile)!r} + '.tmp', 'w').write(str(os.getpid()))\n"
               f"os.rename({str(pidfile)!r} + '.tmp', {str(pidfile)!r})\ntime.sleep(600)")
    failer = (f"import os, sys, time\nwhile not os.path.exists({str(pidfile)!r}): time.sleep(0.01)\n"
              "print('worker says boom'); sys.exit(3)")
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=r"(?s)worker 1 of 2 failed \(exit code 3\).*boom"):
        run_processes([["-c", sleeper], ["-c", failer]], timeout_s=STEP_TIMEOUT)
    assert time.monotonic() - t0 < 30
    pid = int(pidfile.read_text())
    with pytest.raises(ProcessLookupError):
        os.kill(pid, 0)
    assert not _children()


def test_dcn_dryrun_timeout_kills_every_worker():
    with pytest.raises(RuntimeError, match="still running after 0.5 s"):
        dcn_dryrun(2, 4, 256, device="cpu", timeout_s=0.5)
    assert not _children()


# ------------------------------------------------------------------ (e) the transport


def test_backend_policy(monkeypatch):
    cpu, c = torch.device("cpu"), lambda i: torch.device("cuda", i)
    assert t_mesh.choose_backend([[cpu, cpu], [cpu, cpu]]) == "gloo"
    assert t_mesh.choose_backend([[c(0), c(0)], [c(0), c(0)]]) == "gloo"  # a shared card
    assert t_mesh.choose_backend([[c(0), c(1)], [c(1), c(2)]]) == "gloo"  # card 1 shared
    assert t_mesh.choose_backend([[c(0), c(1)], [c(2), c(3)]]) == "nccl"
    assert t_mesh.choose_backend([[c(0)], [c(1)]]) == "nccl"

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert t_mesh.process_devices(2, 2, "cuda") == [[c(0), c(0)], [c(0), c(0)]]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert t_mesh.process_devices(2, 2, "cuda") == [[c(0), c(1)], [c(2), c(3)]]
    assert t_mesh.process_devices(2, 4, "cuda") == [[c(0)] * 4, [c(0)] * 4]
    assert t_mesh.process_devices(2, 2, "cpu") == [[cpu, cpu], [cpu, cpu]]


def test_transport_stages_by_backend():
    cpu = torch.device("cpu")
    tr = t_mesh.Transport("gloo", cpu)
    assert tr.wire == cpu and not tr.pin
    x = torch.arange(12.0).reshape(3, 4)[:, 1:3]
    sent = tr.outgoing(x)
    assert sent.is_contiguous() and torch.equal(sent, x)
    assert tr.incoming((2, 3), torch.float64).dtype == torch.float64
    card = t_mesh.Transport("gloo", torch.device("cuda", 0))
    assert card.wire == cpu and card.pin  # a shared card: pinned host buffers
    nccl = t_mesh.Transport("nccl", torch.device("cuda", 1))
    assert nccl.wire == torch.device("cuda", 1) and not nccl.pin


def _process_mesh():
    """A mesh that names two processes, as process 0 sees it (no group)."""
    return t_mesh.ShardMesh((1, 4), ("b", "x"), ["cpu"] * 4, owners=[0, 0, 1, 1], rank=0,
                            transport=t_mesh.Transport("gloo", torch.device("cpu")))


def test_process_mesh_owns_its_shards():
    mesh = _process_mesh()
    assert mesh.spans_processes and mesh.owns(1) and not mesh.owns(2) and mesh.owns((0, 0))
    assert mesh.distinct_devices() == [torch.device("cpu")] and "2 processes over gloo" in repr(mesh)
    assert not _one_process_mesh((1, 4)).spans_processes
    with pytest.raises(ValueError, match="owns no shard"):
        t_mesh.ShardMesh((2,), ("x",), ["cpu"] * 2, owners=[1, 1], rank=0)
    with pytest.raises(ValueError, match="does not cover"):
        t_mesh.init_process_mesh((1, 4), ("b", "x"), "127.0.0.1:1", 3, 0, 1, "cpu")


def _refusals():
    from satellite_approximation_tpu_torch.parallel import detect, fill, solver, stencils

    img = np.zeros((8, 8), np.float32)
    return {
        "sharded_fill": lambda m: fill.sharded_fill(img, img > 0, m),
        "sharded_masked_cg": lambda m: solver.sharded_masked_cg(img[None], img[None], img > 0,
                                                                img, m),
        "sharded_training_step": solver.sharded_training_step,
        "sharded_gaussian_blur": lambda m: stencils.sharded_gaussian_blur(img, 1.0, m),
        "sharded_pit_fill": lambda m: stencils.sharded_pit_fill(img, 0.0, m),
        "sharded_sweep": detect.sharded_sweep,
        "sharded_alpha_map": lambda m: detect.sharded_alpha_map(img, m),
        "sharded_histograms": lambda m: detect.sharded_histograms(img, img, img > 0, (4, 4), m),
        "mini_detect_sharded": detect.mini_detect_sharded,
    }


@pytest.mark.parametrize("name", sorted(_refusals()))
def test_functions_without_a_cross_process_form_refuse_by_name(name):
    with pytest.raises(NotImplementedError, match=f"^{name} runs on a mesh inside one process"):
        _refusals()[name](_process_mesh())

