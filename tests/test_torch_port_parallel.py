"""The port's data-parallel operations (``convnet_tpu_torch/parallel``,
sync-BN in ``ops/norm.py`` and in the fused MBConv training block) at a
world of two ranks, against the JAX package's on a ``make_mesh(2)`` of the
conftest's virtual CPU devices.

The port's ranks are two spawned processes over gloo
(``torch_port_ranks.py``, which imports no JAX), each on its contiguous half
of the batch, as a single-host JAX mesh shards it. One spawn runs every
case; the JAX references run here.

Tolerances are the single-device comparisons' own (the cross-rank sums add
one more float32 sum in another order): sync-BN 1e-5 as
``test_torch_port_train``'s BN; the MBConv training block 3e-5 (outputs),
1e-4 relative plus 1e-5 (moments), 5e-4 relative plus 5e-5 (gradients), as
``test_torch_port_mbconv``; the ZeRO-1 pieces 1e-6 (the same float32
arithmetic on a few hundred values).
"""

import jax
import jax.flatten_util
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

import torch_port_ranks as ranks
from convnet_tpu import ops as jops
from convnet_tpu.ops.pallas import mbconv as jmb
from convnet_tpu.parallel import zero as jzero
from convnet_tpu.parallel.mesh import make_mesh

try:  # jax>=0.6 exposes shard_map at top level
    from jax import shard_map
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

WORLD = 2
BN_TOL = 1e-5
MB_OUT, MB_STAT, MB_GRAD = 3e-5, (1e-4, 1e-5), (5e-4, 5e-5)
ZERO_TOL = 1e-6
MB_NAMES = ("x", "we", "g1", "b1", "wd", "g2", "b2", "wpj", "g3", "b3")
HP = {"lr": 0.1, "momentum": 0.9, "weight_decay": 1e-4, "trust_coef": 1e-3,
      "beta1": 0.9, "beta2": 0.999, "eps": 1e-8}


def _n(rng, *shape, scale=1.0, loc=0.0):
    return (loc + scale * rng.standard_normal(shape)).astype(np.float32)


def _bn_inputs():
    rng = np.random.default_rng(0)
    return {"x": _n(rng, 8, 5, 6, 8, scale=3, loc=1),
            "scale": rng.uniform(0.5, 1.5, 8).astype(np.float32),
            "bias": _n(rng, 8), "mean": _n(rng, 8),
            "var": rng.uniform(0.5, 2.0, 8).astype(np.float32),
            "dy": _n(rng, 8, 5, 6, 8)}


def _mbconv_inputs(expand, seed):
    rng = np.random.default_rng(seed)
    cin, ch, cout = (8, 16, 8) if expand else (8, 8, 8)
    a = {"x": _n(rng, 4, 6, 6, cin), "we": _n(rng, cin, ch, scale=0.3),
         "g1": _n(rng, ch, scale=0.2, loc=1.0),
         "b1": _n(rng, ch, scale=0.2, loc=1.0),
         "wd": _n(rng, 3, 3, 1, ch, scale=0.3),
         "g2": _n(rng, ch, scale=0.2, loc=1.0),
         "b2": _n(rng, ch, scale=0.2, loc=1.0),
         "wpj": _n(rng, ch, cout, scale=0.3),
         "g3": _n(rng, cout, scale=0.2, loc=0.5),
         "b3": _n(rng, cout, scale=0.2, loc=0.5)}
    if not expand:
        a["we"] = a["g1"] = a["b1"] = None
    return {"args": [a[k] for k in MB_NAMES], "residual": True,
            "dy": _n(rng, 4, 6, 6, cout)}


def _zero_inputs():
    rng = np.random.default_rng(5)
    # three leaves whose flat length (5·3 + 7 + 11 = 33) does not divide
    # by the world: the pad and a leaf straddling the two slices are held
    shapes = [(5, 3), (7,), (11,)]
    return {"params": [_n(rng, *s) for s in shapes],
            "grads": [[_n(rng, *s, scale=0.1) for s in shapes]
                      for _ in range(WORLD)],
            "mask": [True, False, True], "hp": HP}


@pytest.fixture(scope="module")
def ports(tmp_path_factory):
    """Every case on the port's two ranks, in one spawn."""
    payload = {"bn": _bn_inputs(),
               "mbconv": {"expand": _mbconv_inputs(True, 13),
                          "no_expand": _mbconv_inputs(False, 17)},
               "zero": _zero_inputs()}
    return payload, ranks.launch("ops", WORLD,
                                 tmp_path_factory.mktemp("ops"), payload)


def _sharded(f, n_in, n_out_sharded, n_out_replicated=0):
    """``f`` under shard_map on the data axis: the first input and the first
    ``n_out_sharded`` outputs split over the batch, the rest replicated."""
    mesh = make_mesh(WORLD)
    return jax.jit(shard_map(
        f, mesh=mesh, in_specs=(P("data"),) + (P(),) * (n_in - 1),
        out_specs=(P("data"),) * n_out_sharded + (P(),) * n_out_replicated,
        check_vma=False))


def _cat(results, *keys):
    def get(r):
        for k in keys:
            r = r[k]
        return r
    return np.concatenate([get(r) for r in results])


# ------------------------------------------------------------- sync-BN

def _jax_bn(bn):
    def f(x, scale, bias, mean, var):
        return jops.batch_norm_train(x, scale, bias, mean, var,
                                     momentum=0.1, axis_name="data",
                                     axis_size=WORLD)

    sharded = _sharded(f, 5, 1, 2)
    args = [jnp.asarray(bn[k]) for k in ("x", "scale", "bias", "mean",
                                         "var")]
    y, m, v = sharded(*args)
    dx = jax.grad(lambda x: jnp.sum(sharded(x, *args[1:])[0]
                                    * bn["dy"]))(args[0])
    return y, m, v, dx


def test_sync_bn_forward_and_statistics_match_jax(ports):
    payload, out = ports
    y, m, v, _ = _jax_bn(payload["bn"])
    np.testing.assert_allclose(_cat(out, "bn", "y"), y, rtol=BN_TOL,
                               atol=BN_TOL)
    for r in out:   # every rank holds the same statistics: n · world
        np.testing.assert_allclose(r["bn"]["mean"], m, rtol=BN_TOL,
                                   atol=BN_TOL)
        np.testing.assert_allclose(r["bn"]["var"], v, rtol=BN_TOL,
                                   atol=BN_TOL)


def test_sync_bn_gradients_match_jax(ports):
    """dx through the mesh's BN (the backward's cross-rank sum); the
    parameters' gradients summed over the ranks against the full batch's,
    which is what sync-BN over the shards computes."""
    payload, out = ports
    bn = payload["bn"]
    *_, dx = _jax_bn(bn)
    np.testing.assert_allclose(_cat(out, "bn", "dx"), dx, rtol=BN_TOL,
                               atol=BN_TOL)

    def full(scale, bias):
        y, _, _ = jops.batch_norm_train(jnp.asarray(bn["x"]), scale, bias,
                                        jnp.asarray(bn["mean"]),
                                        jnp.asarray(bn["var"]))
        return jnp.sum(y * bn["dy"])

    ds, db = jax.grad(full, argnums=(0, 1))(jnp.asarray(bn["scale"]),
                                            jnp.asarray(bn["bias"]))
    for key, ref in (("dscale", ds), ("dbias", db)):
        np.testing.assert_allclose(sum(r["bn"][key] for r in out), ref,
                                   rtol=BN_TOL, atol=BN_TOL)


def test_sync_bn_differs_from_per_replica_statistics(ports):
    payload, out = ports
    x = payload["bn"]["x"][:8 // WORLD]
    local = x.reshape(-1, x.shape[-1]).mean(0)
    assert not np.allclose(out[0]["bn"]["mean"],
                           0.9 * payload["bn"]["mean"] + 0.1 * local)


# ------------------------------------------------- MBConv under sync-BN

def _jax_mbconv(case, axis):
    args = [None if a is None else jnp.asarray(a) for a in case["args"]]
    live = [i for i, a in enumerate(args) if a is not None]

    def f(x, *rest):
        full = list(args)
        full[0] = x
        for i, r in zip(live[1:], rest):
            full[i] = r
        return jmb.mbconv_train(*full, residual=case["residual"],
                                axis_name=axis, interpret=True)

    return f, args, live


@pytest.mark.parametrize("name", ["expand", "no_expand"])
def test_mbconv_sync_bn_forward_matches_jax(ports, name):
    payload, out = ports
    case = payload["mbconv"][name]
    f, args, live = _jax_mbconv(case, "data")
    mesh = make_mesh(WORLD)
    y, stats = jax.jit(shard_map(
        f, mesh=mesh, in_specs=(P("data"),) + (P(),) * (len(live) - 1),
        out_specs=(P("data"), P()), check_vma=False))(
            *[args[i] for i in live])
    np.testing.assert_allclose(_cat(out, "mbconv", name, "y"), y,
                               rtol=MB_OUT, atol=MB_OUT)
    for r in out:
        for mine, ref in zip(r["mbconv"][name]["stats"], stats):
            assert (mine is None) == (ref is None)
            if ref is not None:
                for a, b in zip(mine, ref):
                    np.testing.assert_allclose(a, b, rtol=MB_STAT[0],
                                               atol=MB_STAT[1])


@pytest.mark.parametrize("name", ["expand", "no_expand"])
def test_mbconv_sync_bn_gradients_match_jax(ports, name):
    """dx through the mesh's block against jax.grad through the shard_map
    of ``mbconv_train(axis_name=)``; each weight's gradient summed over the
    ranks against the full batch's (no axis)."""
    payload, out = ports
    case = payload["mbconv"][name]
    dy = jnp.asarray(case["dy"])
    f, args, live = _jax_mbconv(case, "data")
    mesh = make_mesh(WORLD)
    sharded = shard_map(
        f, mesh=mesh, in_specs=(P("data"),) + (P(),) * (len(live) - 1),
        out_specs=(P("data"), P()), check_vma=False)
    rest = [args[i] for i in live[1:]]
    dx = jax.jit(jax.grad(lambda x: jnp.sum(sharded(x, *rest)[0] * dy)))(
        args[0])
    np.testing.assert_allclose(
        np.concatenate([r["mbconv"][name]["grads"][0] for r in out]), dx,
        rtol=MB_GRAD[0], atol=MB_GRAD[1])
    f_full, _, _ = _jax_mbconv(case, None)
    refs = jax.jit(jax.grad(
        lambda *w: jnp.sum(f_full(args[0], *w)[0] * dy),
        argnums=tuple(range(len(rest)))))(*rest)
    for i, ref in zip(live[1:], refs):
        got = sum(r["mbconv"][name]["grads"][i] for r in out)
        np.testing.assert_allclose(got, ref, rtol=MB_GRAD[0],
                                   atol=MB_GRAD[1], err_msg=MB_NAMES[i])


# ---------------------------------------------------------------- ZeRO-1

def _jax_tree(leaves):
    return {k: jnp.asarray(v) for k, v in zip("abc", leaves)}


def test_zero_flat_layout_matches_jax(ports):
    payload, out = ports
    z = payload["zero"]
    params = _jax_tree(z["params"])
    mask = dict(zip("abc", z["mask"]))
    r = out[0]["zero"]
    assert r["padded"] == jzero.flat_size(params, WORLD) == 34
    np.testing.assert_array_equal(r["mask01"],
                                  jzero.flat_mask01(params, mask, WORLD))
    np.testing.assert_array_equal(r["seg"],
                                  jzero.leaf_segment_ids(params, WORLD))


def _jax_zero(z):
    """The JAX package's reduce-scatter, segment sums, LARS and LAMB steps
    on the mesh; each rank's grads stacked on a leading axis."""
    params = _jax_tree(z["params"])
    mask = dict(zip("abc", z["mask"]))
    padded = jzero.flat_size(params, WORLD)
    flat_p = jnp.pad(jax.flatten_util.ravel_pytree(params)[0],
                     (0, padded - 33))
    seg = jnp.asarray(jzero.leaf_segment_ids(params, WORLD))
    m01 = jnp.asarray(jzero.flat_mask01(params, mask, WORLD))
    leaf_mask = jnp.asarray(jzero.leaf_mask01(params, mask))
    w_sq = jnp.stack([jnp.sum(v * v) for v in params.values()])
    hp = {k: jnp.float32(v) for k, v in z["hp"].items()}
    grads = {k: jnp.stack([jnp.asarray(g[i]) for g in z["grads"]])
             for i, k in enumerate("abc")}

    def f(grads):
        g = jax.tree_util.tree_map(lambda a: a[0], grads)
        g_slice = jzero.reduce_scatter_mean(g, padded, "data")
        p_slice = jzero.shard_slice(flat_p, "data")
        kw = dict(mask01=jzero.shard_slice(m01, "data"),
                  seg_slice=jzero.shard_slice(seg, "data"), w_sq=w_sq,
                  n_leaves=3, axis_name="data")
        lars_p, lars_s = jzero.lars_step_sharded(
            p_slice, g_slice, {"mu": jnp.zeros_like(p_slice),
                               "step": jnp.int32(0)}, hp, **kw)
        lamb_p, lamb_s = jzero.lamb_step_sharded(
            p_slice, g_slice, {"m": jnp.zeros_like(p_slice),
                               "v": jnp.zeros_like(p_slice),
                               "step": jnp.int32(0)}, hp,
            leaf_mask=leaf_mask, **kw)
        g_sq = jzero.segment_sq_sums(g_slice, kw["seg_slice"], 4, "data")
        return (g_slice, lars_p, lars_s["mu"], lamb_p, lamb_s["m"],
                lamb_s["v"], g_sq)

    mesh = make_mesh(WORLD)
    return jax.jit(shard_map(f, mesh=mesh, in_specs=(P("data"),),
                             out_specs=(P("data"),) * 6 + (P(),),
                             check_vma=False))(grads)


def test_zero_reduce_scatter_and_sharded_steps_match_jax(ports):
    payload, out = ports
    g, lars_p, lars_mu, lamb_p, lamb_m, lamb_v, g_sq = _jax_zero(
        payload["zero"])
    for got, ref in ((_cat(out, "zero", "g_slice"), g),
                     (np.concatenate([r["zero"]["lars"][0] for r in out]),
                      lars_p),
                     (np.concatenate([r["zero"]["lars"][1] for r in out]),
                      lars_mu),
                     (np.concatenate([r["zero"]["lamb"][0] for r in out]),
                      lamb_p),
                     (np.concatenate([r["zero"]["lamb"][1] for r in out]),
                      lamb_m),
                     (np.concatenate([r["zero"]["lamb"][2] for r in out]),
                      lamb_v)):
        np.testing.assert_allclose(got, ref, rtol=ZERO_TOL, atol=ZERO_TOL)
    for r in out:
        np.testing.assert_allclose(r["zero"]["g_sq"], g_sq, rtol=ZERO_TOL,
                                   atol=ZERO_TOL)


def test_zero_gather_params_rebuilds_every_tensor(ports):
    """The all-gather of the LARS slices, unraveled into the tensors, on
    every rank; the pad dropped."""
    payload, out = ports
    flat = np.concatenate([r["zero"]["lars"][0] for r in out])[:33]
    offset = 0
    for i, p in enumerate(payload["zero"]["params"]):
        for r in out:
            np.testing.assert_array_equal(
                r["zero"]["gathered"][i],
                flat[offset:offset + p.size].reshape(p.shape))
        offset += p.size


def test_mesh_helpers(ports):
    _, out = ports
    assert [r["mesh"]["local"] for r in out] == [8, 8]
    assert [r["mesh"]["slice"] for r in out] == [slice(0, 8), slice(8, 16)]
    assert [r["mesh"]["size"] for r in out] == [WORLD, WORLD]
