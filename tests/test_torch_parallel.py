"""The port's mesh recipes against the JAX package's
(``tests/test_parallel.py``): ring attention, Ulysses, the dp x tp MLP
step and the dp x tp x sp transformer step.

The JAX side runs on the conftest's virtual 8-device mesh.  The port side
runs as 8 gloo processes on the CPU, ONE ``run_multiproc`` launch for the
whole file (``parsec_tpu_torch.parallel.bodies.mesh_body``): every case's
job runs in it on a mesh of its own shape (an extra axis ``x`` replicates
a job that needs fewer than 8 ranks), and the cases read its results.
The inputs are the JAX tests' (``jax.random`` draws), carried across as
numpy arrays in an ``.npz``; each rank returns its blocks and the test
assembles them by the rank's mesh coordinates.

Tolerances: attention outputs within ``2e-5`` of the JAX run and of
``dense_attention`` (the JAX test's); the parameters after a step within
``rtol=1e-4, atol=1e-5`` (MLP) and ``rtol=1e-3, atol=1e-5`` (the
transformer, its parameters scaled 25x as in the JAX test), the loss
within ``rtol=1e-5`` and ``1e-4``.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh as JMesh

from parsec_tpu.parallel.alltoall import make_ulysses_attention
from parsec_tpu.parallel.ring import dense_attention, make_ring_attention
from parsec_tpu.parallel.train import (init_params, init_transformer_params,
                                       make_train_step,
                                       make_transformer_train_step)
from parsec_tpu_torch.comm import run_multiproc
from parsec_tpu_torch.parallel.train import (MLP_SPECS,
                                             transformer_param_specs)

NPROC = 8
ATTN = ("dp", "tp", "sp", None)


def _jmesh(shape: dict) -> JMesh:
    devs = np.array(jax.devices()[:int(np.prod(list(shape.values())))])
    return JMesh(devs.reshape(tuple(shape.values())),
                 axis_names=tuple(shape.keys()))


def _qkv(key, b=2, h=4, n=16, d=8):
    ks = jax.random.split(key, 3)
    return tuple(np.asarray(jax.random.normal(k, (b, h, n, d), jnp.float32))
                 for k in ks)


def _cases() -> tuple[dict, list[dict], dict]:
    """The arrays, the port's jobs and the JAX results, by case name."""
    arrays, jobs, want = {}, [], {}

    def attn(name, mesh, kind, key, causal, **shape):
        q, k, v = _qkv(key, **shape)
        for nm, t in zip("qkv", (q, k, v)):
            arrays[f"{name}_{nm}"] = t
        jobs.append({"name": name, "kind": kind, "mesh": mesh,
                     "shape": list(q.shape), "causal": causal, "ret": 1,
                     "keys": {nm: f"{name}_{nm}" for nm in "qkv"}})
        return q, k, v

    for sp in (2, 4, 8):
        for causal in (False, True):
            name = f"ring_sp{sp}_{int(causal)}"
            q, k, v = attn(name, {"x": NPROC // sp, "sp": sp}, "ring",
                           jax.random.PRNGKey(0), causal)
            ring = make_ring_attention(_jmesh({"sp": sp}), causal=causal,
                                       batch_axis=None, head_axis=None)
            want[name] = (np.asarray(ring(q, k, v)),
                          np.asarray(dense_attention(q, k, v,
                                                     causal=causal)))
    q, k, v = attn("ring_full", {"dp": 2, "tp": 2, "sp": 2}, "ring",
                   jax.random.PRNGKey(1), True, b=4)
    ring = make_ring_attention(_jmesh({"dp": 2, "tp": 2, "sp": 2}),
                               causal=True)
    want["ring_full"] = (np.asarray(ring(q, k, v)),
                         np.asarray(dense_attention(q, k, v, causal=True)))
    q, k, v = attn("ulysses", {"x": 2, "sp": 4}, "ulysses",
                   jax.random.PRNGKey(2), False, h=8, d=4)
    ul = make_ulysses_attention(
        _jmesh({"sp": 4}), lambda a, b_, c: dense_attention(a, b_, c),
        batch_axis=None)
    want["ulysses"] = (np.asarray(ul(q, k, v)),
                       np.asarray(dense_attention(q, k, v)))

    # the dp x tp MLP step
    params = init_params(jax.random.PRNGKey(0), 16, 32)
    x = jax.random.normal(jax.random.PRNGKey(1), (8, 4, 16))
    y = jax.random.normal(jax.random.PRNGKey(2), (8, 4, 16))
    p2, loss = make_train_step(_jmesh({"dp": 2, "tp": 4}), lr=0.1)(
        params, x, y)
    for nm, t in (("w1", params["w1"]), ("w2", params["w2"]), ("x", x),
                  ("y", y)):
        arrays[f"mlp_{nm}"] = np.asarray(t)
    jobs.append({"name": "mlp", "kind": "mlp", "mesh": {"dp": 2, "tp": 4},
                 "d_model": 16, "d_ff": 32, "batch": 8, "seq": 4,
                 "lr": 0.1, "ret": 1,
                 "keys": {nm: f"mlp_{nm}" for nm in ("w1", "w2", "x", "y")}})
    want["mlp"] = ({k: np.asarray(v) for k, v in p2.items()}, float(loss))

    # the flagship transformer step: one step (params scaled 25x), and
    # five steps at init scale towards y = x / 2
    tmesh = _jmesh({"dp": 2, "tp": 2, "sp": 2})
    tparams = jax.tree.map(lambda p: p * 25.0, init_transformer_params(
        jax.random.PRNGKey(0), 16, 4, 4, 32))
    x = jax.random.normal(jax.random.PRNGKey(1), (4, 8, 16))
    y = jax.random.normal(jax.random.PRNGKey(2), (4, 8, 16))
    p2, loss = make_transformer_train_step(tmesh, 4, 4, lr=0.05,
                                           causal=True)(tparams, x, y)
    keys = {}
    for nm, t in list(tparams.items()) + [("x", x), ("y", y)]:
        arrays[f"tf_{nm}"] = np.asarray(t)
        keys[nm] = f"tf_{nm}"
    common = {"kind": "transformer", "mesh": {"dp": 2, "tp": 2, "sp": 2},
              "d_model": 16, "n_heads": 4, "d_head": 4, "d_ff": 32,
              "batch": 4, "seq": 8, "ret": 1}
    jobs.append(dict(common, name="transformer", lr=0.05, causal=True,
                     keys=keys))
    want["transformer"] = ({k: np.asarray(v) for k, v in p2.items()},
                           float(loss))
    params = init_transformer_params(jax.random.PRNGKey(0), 16, 4, 4, 32)
    jstep = make_transformer_train_step(tmesh, 4, 4, lr=0.1)
    losses = []
    for _ in range(5):
        params, loss = jstep(params, x, x * 0.5)
        losses.append(float(loss))
    keys = {}
    for nm, t in init_transformer_params(jax.random.PRNGKey(0), 16, 4, 4,
                                         32).items():
        arrays[f"tf5_{nm}"] = np.asarray(t)
        keys[nm] = f"tf5_{nm}"
    keys["x"] = "tf_x"
    jobs.append(dict(common, name="transformer_5", lr=0.1, causal=True,
                     steps=5, target="half_x", keys=keys))
    want["transformer_5"] = losses
    return arrays, jobs, want


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    arrays, jobs, want = _cases()
    path = tmp_path_factory.mktemp("par") / "inputs.npz"
    np.savez(path, **arrays)
    for j in jobs:
        j["inputs"] = str(path)
    saved = os.environ.get("PARSEC_PAR_SPEC")
    os.environ["PARSEC_PAR_SPEC"] = json.dumps(jobs)
    try:
        res = run_multiproc(NPROC, "parsec_tpu_torch.parallel.bodies:"
                            "mesh_body", timeout=240, transport="device",
                            distributed=True, device="cpu")
    finally:
        if saved is None:
            os.environ.pop("PARSEC_PAR_SPEC", None)
        else:
            os.environ["PARSEC_PAR_SPEC"] = saved
    names = [j["name"] for j in jobs]
    by_name = {nm: [r[i] for r in res] for i, nm in enumerate(names)}
    return by_name, want


def _assemble(results: list[dict], key: str, spec: tuple) -> np.ndarray:
    """The whole array from the ranks' blocks, placed by coordinates (one
    replica: ``x == 0``)."""
    blocks = [(r["coords"], r[key]) for r in results
              if r["coords"].get("x", 0) == 0]
    shape = list(blocks[0][1].shape)
    for dim, ax in enumerate(spec):
        if ax is not None and ax in blocks[0][0]:
            shape[dim] *= max(c[ax] for c, _ in blocks) + 1
    out = np.zeros(shape, blocks[0][1].dtype)
    for c, b in blocks:
        sl = []
        for dim, ax in enumerate(spec):
            off = c[ax] * b.shape[dim] if ax is not None and ax in c else 0
            sl.append(slice(off, off + b.shape[dim]))
        out[tuple(sl)] = b
    return out


def _params(results: list[dict], specs: dict) -> dict:
    return {k: _assemble([dict(r, p=r["params"][k]) for r in results], "p",
                         spec) for k, spec in specs.items()}


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sp", [2, 4, 8])
def test_ring_attention_matches_the_jax_ring(runs, causal, sp):
    by_name, want = runs
    got = _assemble(by_name[f"ring_sp{sp}_{int(causal)}"], "out", ATTN)
    jring, dense = want[f"ring_sp{sp}_{int(causal)}"]
    np.testing.assert_allclose(got, jring, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, dense, rtol=2e-5, atol=2e-5)


def test_ring_attention_on_the_full_mesh(runs):
    by_name, want = runs
    got = _assemble(by_name["ring_full"], "out", ATTN)
    np.testing.assert_allclose(got, want["ring_full"][0], rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(got, want["ring_full"][1], rtol=2e-5,
                               atol=2e-5)


def test_ulysses_matches_the_jax_ulysses(runs):
    by_name, want = runs
    got = _assemble(by_name["ulysses"], "out", ATTN)
    np.testing.assert_allclose(got, want["ulysses"][0], rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(got, want["ulysses"][1], rtol=2e-5,
                               atol=2e-5)


def test_the_mlp_step_matches_the_jax_step(runs):
    by_name, want = runs
    jp, jloss = want["mlp"]
    got = _params(by_name["mlp"], MLP_SPECS)
    for k in jp:
        np.testing.assert_allclose(got[k], jp[k], rtol=1e-4, atol=1e-5)
    for r in by_name["mlp"]:
        np.testing.assert_allclose(r["loss"], jloss, rtol=1e-5)


def test_the_transformer_step_matches_the_jax_step(runs):
    by_name, want = runs
    jp, jloss = want["transformer"]
    got = _params(by_name["transformer"], transformer_param_specs())
    for k in jp:
        np.testing.assert_allclose(got[k], jp[k], rtol=1e-3, atol=1e-5)
    for r in by_name["transformer"]:
        np.testing.assert_allclose(r["losses"][0], jloss, rtol=1e-4)


def test_the_transformer_loss_falls_as_in_the_jax_run(runs):
    by_name, want = runs
    losses = by_name["transformer_5"][0]["losses"]
    assert losses[-1] < losses[0], losses
    np.testing.assert_allclose(losses, want["transformer_5"], rtol=1e-4)
    assert all(r["losses"] == losses for r in by_name["transformer_5"])
