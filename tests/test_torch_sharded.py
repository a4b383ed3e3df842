"""The port's sharded engines, distributed scans and mesh builders
(``repro_torch.core.*_sharded``, ``core.prefix.shard_*``,
``repro_torch.launch.mesh``) against the JAX package on the CPU.

The port runs in gloo worlds of 8 and of 3 CPU ranks
(``tests/_torch_sharded_worker.py``; each world is spawned once per module
and runs every case).  The same numpy inputs, made from a seed, go to both
packages; every result is an integer, so every comparison is exact.

* Where the result does not depend on how the stream is split, the port
  is held against the single-device reference in this process: the
  counts, the uncapped enumerate buffer (order included: the JAX
  package's ``sbm_enumerate_sharded`` on a mesh of one device, whose
  stitched order is the same on every mesh), the bit-matrix words and
  count, the distributed cumsum.
* Where it does (a shard buffer of ``max_pairs_per_shard`` that cuts,
  leaving holes), against the sharded reference on an Auto mesh of 8 and
  of 3 host devices, in one subprocess (x64 on: the port's counts are
  exact int64); that subprocess also runs every engine once at P = 8.

Past 2³¹ pairs the port's exact counts are held against
``sbm_count_exact`` (port only: the JAX package without x64 saturates).
"""
import inspect
import os
import pathlib
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro import core as rcore
from repro.core.intervals import Extents as RefExtents
from repro.launch.mesh import make_elastic_mesh as ref_elastic_mesh
from repro.launch.mesh import make_host_mesh as ref_host_mesh
from repro_torch.core import ValidationError, sbm_count_exact
from repro_torch.core.intervals import Extents
from repro_torch.launch import mesh as mesh_lib
from _torch_sharded_worker import BF_BLOCK, run_world

jax.config.update("jax_platform_name", "cpu")

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORLDS = (8, 3)
LENGTH = 1000.0
MAX_PAIRS = 4096
CUT_PAIRS = 1500                  # below the cut workload's K
CAPS = {8: 256, 3: 512}           # a shard buffer that cuts at each P
WIDE = (65_536, 65_536)           # K = 2**32 identical pairs


def _uniform(rng, n, m, alpha, d=1):
    seg = alpha * LENGTH / (n + m)
    shape = (n + m,) if d == 1 else (d, n + m)
    lo = rng.uniform(0.0, LENGTH - seg, shape).astype(np.float32)
    return lo, lo + np.float32(seg)


def _split(lo, hi, n):
    return (np.ascontiguousarray(lo[..., :n]), np.ascontiguousarray(hi[..., :n]),
            np.ascontiguousarray(lo[..., n:]), np.ascontiguousarray(hi[..., n:]))


def _workloads():
    """name -> (s_lo, s_hi, u_lo, u_hi) float32 numpy arrays, one seed."""
    rng = np.random.default_rng(26)
    counts = {"uniform": _split(*_uniform(rng, 300, 340, 10.0), 300)}
    centers = rng.uniform(0.0, LENGTH, 4)
    lo = np.clip(centers[rng.integers(0, 4, 250)]
                 + rng.normal(0.0, LENGTH / 80, 250), 0.0, LENGTH - 4.0)
    lo = lo.astype(np.float32)
    counts["clustered"] = _split(lo, lo + np.float32(4.0), 130)
    lo = rng.integers(0, 24, 90).astype(np.float32)
    hi = lo + rng.integers(0, 5, 90).astype(np.float32)
    lo[lo == 0.0] = np.float32(-0.0)
    counts["ties"] = _split(lo, hi, 41)          # n not a multiple of P
    # 24,000 endpoints: the count's stream (padded to P segments of
    # COUNT_BLOCK) spans several ranks, so the carry crosses ranks
    counts["uniform long"] = _split(*_uniform(rng, 6000, 6000, 0.5), 6000)
    counts["n=0"] = _split(*_uniform(rng, 0, 20, 4.0), 0)
    counts["m=0"] = _split(*_uniform(rng, 20, 0, 4.0), 20)
    # 4 endpoints: more ranks than real endpoints at P = 8
    counts["n=m=1"] = (np.float32([1.0]), np.float32([3.0]),
                       np.float32([2.0]), np.float32([5.0]))
    tall = _uniform(rng, 101, 90, 8.0, d=2)
    tall[0][0] = rng.uniform(0.0, 0.02 * LENGTH, 191).astype(np.float32)
    tall[1][0] = tall[0][0] + np.float32(0.98 * LENGTH)
    bitmatrix = {"uniform d=1": counts["uniform"],
                 "tall-thin d=2": _split(*tall, 101),
                 "uniform d=3": _split(*_uniform(rng, 37, 70, 30.0, d=3), 37),
                 "n=2 d=2": _split(*_uniform(rng, 2, 45, 20.0, d=2), 2)}
    return counts, bitmatrix


COUNTS, BITMATRIX = _workloads()
CUT = COUNTS["uniform"]


def _spec() -> dict:
    return {"cumsum": np.random.default_rng(7).integers(-5, 6, 48)
            .astype(np.int32),
            "counts": COUNTS, "bitmatrix": BITMATRIX, "max_pairs": MAX_PAIRS,
            "cut": CUT, "cut_pairs": CUT_PAIRS, "caps": CAPS, "wide": WIDE}


def _ref(s_lo, s_hi, u_lo, u_hi):
    return (RefExtents(jnp.asarray(s_lo), jnp.asarray(s_hi)),
            RefExtents(jnp.asarray(u_lo), jnp.asarray(u_hi)))


# --------------------------------------------------------------------------
# The sharded reference on Auto meshes of 8 and 3 host devices
# --------------------------------------------------------------------------

_REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from repro.core import (Extents, bf_count_sharded, bitmatrix_sharded,
                            rank_count_sharded, sbm_count_sharded,
                            sbm_enumerate_sharded)
    from repro.launch.mesh import make_host_mesh

    assert jax.config.read("jax_enable_x64") and len(jax.devices()) == 8
    arrays = np.load(sys.argv[1])
    out = {}
    cut = [jnp.asarray(arrays[f"cut{k}"]) for k in range(4)]
    tall = [jnp.asarray(arrays[f"tall{k}"]) for k in range(4)]
    for p in (8, 3):
        mesh = make_host_mesh(p, "p")
        ext = lambda a: (Extents(a[0], a[1]), Extents(a[2], a[3]))
        # jit: an eager shard_map runs op by op on every device
        pairs, count = jax.jit(lambda *a: sbm_enumerate_sharded(
            *ext(a), mesh, "p", max_pairs=int(arrays["max_pairs"]),
            max_pairs_per_shard=int(arrays[f"cap{p}"])))(*cut)
        out[f"capped{p}"], out[f"capped_count{p}"] = pairs, count
        if p == 8:
            for name, fn in (("sbm", sbm_count_sharded),
                             ("rank", rank_count_sharded)):
                out[name] = jax.jit(lambda *a, fn=fn: fn(*ext(a), mesh,
                                                         "p"))(*cut)
            out["bf"] = jax.jit(lambda *a: bf_count_sharded(
                *ext(a), mesh, "p", block=int(arrays["block"])))(*cut)
            out["words"], out["words_count"] = jax.jit(
                lambda *a: bitmatrix_sharded(*ext(a), mesh, "p"))(*tall)
    np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
""")


def _start_reference(tmp: pathlib.Path):
    args = {"max_pairs": MAX_PAIRS, "block": BF_BLOCK,
            **{f"cut{k}": a for k, a in enumerate(CUT)},
            **{f"cap{p}": c for p, c in CAPS.items()},
            **{f"tall{k}": a for k, a in enumerate(BITMATRIX["tall-thin d=2"])}}
    np.savez(tmp / "ref_in.npz", **args)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_ENABLE_X64="1",
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return subprocess.Popen(
        [sys.executable, "-c", _REFERENCE, str(tmp / "ref_in.npz"),
         str(tmp / "ref_out.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def _spawn_world(world: int, tmp: pathlib.Path) -> list:
    out = tmp / f"world{world}"
    out.mkdir()
    mp.start_processes(run_world, args=(world, str(out / "init"), _spec(),
                                        str(out)),
                       nprocs=world, join=True, start_method="spawn")
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{P: [rank 0's results, ..., rank P-1's]} and the sharded reference's
    arrays."""
    tmp = tmp_path_factory.mktemp("sharded")
    reference = _start_reference(tmp)
    try:
        worlds = {p: _spawn_world(p, tmp) for p in WORLDS}
        stdout, stderr = reference.communicate(timeout=600)
    finally:
        if reference.poll() is None:
            reference.kill()
            reference.communicate()
    assert reference.returncode == 0, f"stdout:\n{stdout}\nstderr:\n{stderr}"
    return worlds, dict(np.load(tmp / "ref_out.npz"))


@pytest.fixture(scope="module")
def ref_mesh():
    return ref_host_mesh(1, "p")


def _pairs(t) -> np.ndarray:
    return t.numpy().astype(np.int32)


# --------------------------------------------------------------------------
# Against the single-device reference
# --------------------------------------------------------------------------

REF_COUNT = {"sbm": rcore.sbm_count, "rank": rcore.rank_count,
             "bf": lambda s, u: rcore.bf_count(s, u, block=BF_BLOCK)}


@pytest.mark.parametrize("engine", sorted(REF_COUNT))
@pytest.mark.parametrize("workload", sorted(COUNTS))
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_count_equals_the_reference(runs, world, workload, engine):
    got = runs[0][world][0][f"{engine} {workload}"]
    assert got.dtype == torch.int64 and got.shape == ()
    want = int(REF_COUNT[engine](*_ref(*COUNTS[workload])))
    assert int(got) == want == rcore.brute_force_count_numpy(
        *_ref(*COUNTS[workload]))


@pytest.mark.parametrize("workload", sorted(COUNTS))
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_enumerate_equals_the_reference_row_for_row(
        runs, ref_mesh, world, workload):
    """Uncapped, the stitched buffer does not depend on the shard layout:
    the JAX package's on one device gives the same rows in the same order."""
    pairs, count = runs[0][world][0][f"enumerate {workload}"]
    subs, upds = _ref(*COUNTS[workload])
    want_pairs, want_count = jax.jit(lambda s, u: rcore.sbm_enumerate_sharded(
        s, u, ref_mesh, "p", max_pairs=MAX_PAIRS))(subs, upds)
    assert count.dtype == torch.int64 and int(count) == int(want_count)
    assert int(count) <= MAX_PAIRS
    np.testing.assert_array_equal(_pairs(pairs), np.asarray(want_pairs))
    want_set = rcore.brute_force_pairs_numpy(subs, upds)
    assert {(i, j) for i, j in _pairs(pairs).tolist() if i >= 0} == want_set


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_enumerate_cut_by_max_pairs_equals_the_reference(
        runs, ref_mesh, world):
    pairs, count = runs[0][world][0]["enumerate cut"]
    want_pairs, want_count = jax.jit(lambda s, u: rcore.sbm_enumerate_sharded(
        s, u, ref_mesh, "p", max_pairs=CUT_PAIRS))(*_ref(*CUT))
    assert int(count) == int(want_count) > CUT_PAIRS
    np.testing.assert_array_equal(_pairs(pairs), np.asarray(want_pairs))
    assert (_pairs(pairs)[:, 0] >= 0).all()


@pytest.mark.parametrize("workload", sorted(BITMATRIX))
@pytest.mark.parametrize("world", WORLDS)
def test_bitmatrix_sharded_equals_the_reference(runs, world, workload):
    words, count = runs[0][world][0][f"bitmatrix {workload}"]
    subs, upds = _ref(*BITMATRIX[workload])
    want = np.asarray(rcore.bitmatrix_words(subs, upds))
    assert words.dtype == torch.int32
    np.testing.assert_array_equal(words.numpy().view(np.uint32), want)
    assert count.dtype == torch.int64
    assert int(count) == int(rcore.bitmatrix_count(subs, upds)) \
        == len(rcore.brute_force_pairs_numpy(subs, upds))


@pytest.mark.parametrize("world", WORLDS)
def test_shard_scans_equal_the_serial_scan(runs, world):
    x = _spec()["cumsum"]
    ranks = runs[0][world]
    got = np.concatenate([r["cumsum"].numpy() for r in ranks])
    np.testing.assert_array_equal(got, np.cumsum(x))
    assert ranks[0]["cumsum"].dtype == torch.int32
    shard = len(x) // world
    for r, res in enumerate(ranks):
        before = int(x[:r * shard].sum())
        assert res["offsets"].tolist() == [before, -before]


# --------------------------------------------------------------------------
# Against the sharded reference (the layout matters)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("world", WORLDS)
def test_capped_shard_buffers_equal_the_sharded_reference(runs, world):
    """A shard that emits more than ``max_pairs_per_shard`` leaves (-1, -1)
    holes in the stitched buffer exactly where the reference leaves them."""
    worlds, ref = runs
    pairs, count = worlds[world][0]["enumerate capped"]
    want = ref[f"capped{world}"]
    np.testing.assert_array_equal(_pairs(pairs), want)
    assert int(count) == int(ref[f"capped_count{world}"])
    holes = (want[:int(count), 0] < 0).sum()
    assert 0 < holes < int(count)


@pytest.mark.parametrize("engine", ["sbm", "rank", "bf", "bitmatrix"])
def test_every_engine_equals_the_sharded_reference_at_8(runs, engine):
    worlds, ref = runs
    res = worlds[8][0]
    if engine == "bitmatrix":
        words, count = res["bitmatrix tall-thin d=2"]
        np.testing.assert_array_equal(words.numpy().view(np.uint32),
                                      ref["words"])
        assert int(count) == int(ref["words_count"])
    else:
        assert int(res[f"{engine} uniform"]) == int(ref[engine])


# --------------------------------------------------------------------------
# The port alone: past 2**31, every rank's answer, the collectives, meshes
# --------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ["sbm", "rank", "enumerate"])
@pytest.mark.parametrize("world", WORLDS)
def test_count_past_2_31_is_exact(runs, world, engine):
    n, m = WIDE
    got = runs[0][world][0][f"wide {engine}"]
    if engine == "enumerate":
        pairs, got = got
        assert (_pairs(pairs) >= 0).all()
    subs = Extents(torch.zeros(n), torch.ones(n))
    upds = Extents(torch.full((m,), 0.5), torch.full((m,), 2.0))
    assert int(got) == n * m == sbm_count_exact(subs, upds)


def _same(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_gets_the_same_result(runs, world):
    ranks = runs[0][world]
    skip = {"cumsum", "offsets", "mesh"}
    for res in ranks[1:]:
        assert res.keys() == ranks[0].keys()
        for key in ranks[0].keys() - skip:
            assert _same(res[key], ranks[0][key]), key


@pytest.mark.parametrize("world", WORLDS)
def test_gather_and_reduce_over_the_world(runs, world):
    for res in runs[0][world]:
        want = torch.arange(3, dtype=torch.int32) + 10 * torch.arange(
            world, dtype=torch.int32)[:, None]
        assert _same(res["gather"], want)
        assert res["gather empty"].shape == (world, 0)
        assert _same(res["reduce"], want.sum(dim=0, dtype=torch.int32))


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_builders(runs, world):
    for rank, res in enumerate(runs[0][world]):
        mesh = res["mesh"]
        assert "needs 256 ranks" in mesh["production"]
        assert "needs 512 ranks" in mesh["multi-pod"]
        assert mesh["host num=0"].startswith("ValidationError")
        assert "not divisible by model_parallel" in mesh["elastic indivisible"]
        assert mesh["elastic"] == ((1, world), ("data", "model"))
        assert mesh["host"] == ((world,), ("p",))
        assert mesh["host num>world"] == (world,)
        assert "no dimension 'model'" in mesh["unknown axis"]
        # the first two ranks run the engine; the rest are not in the mesh
        if rank < 2:
            assert int(mesh["host num=2"]) == 4
        else:
            assert "not in the mesh" in mesh["host num=2"]


def test_mesh_builders_default_to_the_card():
    for build in (mesh_lib.make_host_mesh, mesh_lib.make_elastic_mesh,
                  mesh_lib.make_production_mesh):
        assert inspect.signature(build).parameters["device"].default \
            == "cuda", build


def test_mesh_builders_need_an_initialised_group():
    for build in (mesh_lib.make_host_mesh, mesh_lib.make_elastic_mesh,
                  mesh_lib.make_production_mesh):
        with pytest.raises(ValidationError, match="init_process_group"):
            build(device="cpu")


def test_indivisible_model_parallel_is_the_reference_error():
    """The JAX package raises ValueError; the port's ValidationError is one."""
    assert issubclass(ValidationError, ValueError)
    with pytest.raises(ValueError, match="not divisible by model_parallel"):
        ref_elastic_mesh(jax.devices(), model_parallel=2)
