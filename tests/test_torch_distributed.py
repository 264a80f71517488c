"""The port's multi-rank modules on gloo groups of spawned CPU processes,
against ``repro``'s functions run under ``jax.set_mesh`` with 8 forced
host devices: ``compressed_psum_grads`` (and the reference test's
error-feedback bound), ``pipeline_forward`` (and sequential application),
an elastic restore of the reference's int8 checkpoint onto a 2 x 2 mesh
under ``fsdp_tp``, and ``DeviceFeed`` with shardings on 2 ranks.  Each
multi-rank run has its own time limit (``_torch_dist.run_ranks``)."""

import ast

import jax
import numpy as np
import pytest

from _torch_dist import (compress_worker, feed_worker, pipeline_worker,
                         restore_worker, run_jax, run_ranks)
from repro.configs.base import ArchConfig as JaxArchConfig
from repro.models import build_model as jax_build_model
from repro.train import optimizer as jax_opt
from repro.train.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.train.step import init_state as jax_init_state

STEPS = 12


def test_compressed_psum_matches_reference_and_converges(tmp_path):
    """8 ranks, 12 rounds with error feedback: each round's mean
    gradient and the final residuals equal the reference's
    ``compressed_psum_grads`` under ``shard_map``; and the reference
    test's bound, the summed applied update within 0.08 x scale of the
    true mean's."""
    grads = np.random.default_rng(0).standard_normal((8, 4, 16)).astype(
        np.float32)
    np.save(tmp_path / "grads.npy", grads)
    run_jax(f"""
        import jax, jax.numpy as jnp, numpy as np
        from jax.sharding import Mesh, PartitionSpec as P
        from repro.train.compression import compressed_psum_grads
        mesh = Mesh(np.array(jax.devices()), ("data",))
        grads = {{"w": jnp.asarray(np.load({str(tmp_path / "grads.npy")!r}))}}
        errors = {{"w": jnp.zeros((8, 4, 16))}}
        with jax.set_mesh(mesh):
            f = jax.jit(jax.shard_map(
                lambda g, e: compressed_psum_grads(g, e, "data"),
                mesh=mesh, in_specs=(P("data"), P("data")),
                out_specs=(P("data"), P("data"))))
            outs = []
            for _ in range({STEPS}):
                out, errors = f(grads, errors)
                outs.append(np.asarray(out["w"]))
        np.savez({str(tmp_path / "ref.npz")!r}, outs=np.stack(outs),
                 err=np.asarray(errors["w"]))
    """)
    ref = np.load(tmp_path / "ref.npz")
    got = run_ranks(tmp_path, 8, compress_worker, grads, STEPS)
    for rank in range(8):
        np.testing.assert_allclose(got[rank]["outs"][:, 0],
                                   ref["outs"][:, rank], rtol=1e-6,
                                   atol=1e-7, err_msg=f"rank {rank}")
        # g + e - q * scale cancels: XLA may contract it into an FMA, so
        # the residuals agree to an ulp of the gradients (|g| < 4, ulp
        # 4.8e-7) a round, over 12 rounds
        np.testing.assert_allclose(got[rank]["err"][0], ref["err"][rank],
                                   rtol=0, atol=STEPS * 4.8e-7)
    applied = np.stack([r["outs"].sum(0)[0] for r in got])
    mean = grads.mean(axis=0, keepdims=True) * STEPS
    err = np.abs(applied - mean).max()
    assert err < 0.08 * np.abs(mean).max()


def test_pipeline_forward_matches_reference_and_sequential(tmp_path):
    """S = 4 stages on 4 ranks, M = 6 microbatches, 8 tanh layers:
    every rank's output equals the reference's ``pipeline_forward`` under
    ``jax.set_mesh`` and the layers applied in sequence."""
    S, M, L, d = 4, 6, 8, 16
    rng = np.random.default_rng(1)
    w = (0.2 * rng.standard_normal((L, d, d))).astype(np.float32)
    x = rng.standard_normal((M, 4, d)).astype(np.float32)
    np.savez(tmp_path / "in.npz", w=w, x=x)
    run_jax(f"""
        import jax, jax.numpy as jnp, numpy as np
        from jax.sharding import Mesh
        from repro.train.pipeline_parallel import (pipeline_forward,
                                                   stack_stage_params)
        z = np.load({str(tmp_path / "in.npz")!r})
        w, x = jnp.asarray(z["w"]), jnp.asarray(z["x"])
        mesh = Mesh(np.array(jax.devices()[:{S}]), ("stage",))

        def stage_fn(params, h):
            def body(h, wl):
                return jnp.tanh(h @ wl), None
            return jax.lax.scan(body, h, params)[0]

        with jax.set_mesh(mesh):
            piped = jax.jit(pipeline_forward(stage_fn, {S}, {M}, mesh))
            y = piped(stack_stage_params(w, {S}), x)
        np.save({str(tmp_path / "ref.npy")!r}, np.asarray(y))
    """)
    ref = np.load(tmp_path / "ref.npy")
    want = x
    for layer in w:
        want = np.tanh(want @ layer)
    got = run_ranks(tmp_path, S, pipeline_worker, w, x)
    for rank in range(S):
        np.testing.assert_allclose(got[rank]["y"], ref, rtol=2e-5,
                                   atol=2e-5, err_msg=f"rank {rank}")
        np.testing.assert_allclose(got[rank]["y"], want, rtol=2e-5,
                                   atol=2e-5)


QUICKSTART = dict(name="quickstart-lm", family="dense", n_layers=2,
                  d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
                  vocab=2048, head_dim=32, dtype="float32", remat=False)


def _split(spec, shape, rank, mesh=(("data", 2), ("model", 2))):
    """The index of ``rank``'s block of a tensor under ``spec`` on a
    (2, 2) mesh whose rank r sits at (r // 2, r % 2)."""
    sizes = dict(mesh)
    coord = {"data": rank // 2, "model": rank % 2}
    idx = []
    for dim, part in zip(shape, list(spec) + [None] * len(shape)):
        axes = part if isinstance(part, tuple) else (part,)
        axes = [a for a in axes if a is not None]
        n, k = 1, 0
        for a in axes:                       # row-major over the tuple
            k = k * sizes[a] + coord[a]
            n *= sizes[a]
        step = dim // n
        idx.append(slice(k * step, (k + 1) * step))
    return tuple(idx)


@pytest.mark.parametrize("state_dtype", ["int8", "int8_factored"])
def test_elastic_restore_onto_a_2x2_mesh(state_dtype, tmp_path):
    """The reference saves a trained int8 state; 4 gloo ranks restore it
    with ``tree_shardings(abstract_state(...), ..., "fsdp_tp")`` on a
    (2, 2) mesh: every leaf a DTensor, its whole tensor bit-equal to the
    saved array, each rank's shard the block its mesh position owns, and
    leaves sharded over both axes among them."""
    jm = jax_build_model(JaxArchConfig(**QUICKSTART))
    cfg = jax_opt.OptimizerConfig(state_dtype=state_dtype)
    state = jax_init_state(jm, cfg, jax.random.PRNGKey(0))
    grads = jax.tree.map(lambda p: jax.random.normal(
        jax.random.PRNGKey(1), p.shape), state["params"])
    p, o, _ = jax_opt.adamw_update(grads, state["opt"], state["params"], cfg)
    JaxCheckpointManager(str(tmp_path / "ckpt")).save(5, {"params": p,
                                                           "opt": o})
    saved = np.load(tmp_path / "ckpt" / "step_00000005" / "arrays.npz")
    got = run_ranks(tmp_path, 4, restore_worker, str(tmp_path / "ckpt"),
                    QUICKSTART, state_dtype, "fsdp_tp")
    keys = [k[len("full/"):] for k in got[0] if k.startswith("full/")]
    assert set(keys) == set(saved.files)
    both = 0
    for key in keys:
        spec = ast.literal_eval(str(got[0]["spec/" + key]))
        both += {"data", "model"} <= set(a for a in spec if a)
        for rank in range(4):
            assert int(got[rank]["step"]) == 5
            np.testing.assert_array_equal(got[rank]["full/" + key],
                                          saved[key], err_msg=key)
            np.testing.assert_array_equal(
                got[rank]["local/" + key],
                saved[key][_split(spec, saved[key].shape, rank)],
                err_msg=f"{key} rank {rank}")
    assert both > 0


def test_device_feed_places_process_local_rows(tmp_path):
    """2 ranks, each loading its shard: with ``mesh=`` (every key) or
    ``shardings=`` (tokens only), a key comes as a DTensor whose local
    rows are the rank's own batch (what a plain feed on the same shard
    gives) and whose whole tensor stacks both ranks' rows in rank
    order."""
    got = run_ranks(tmp_path, 2, feed_worker, 16)
    for i in range(2):
        for k in ("tokens", "loss_mask", "labels"):
            plain = [got[r][f"plain/{i}/{k}"] for r in range(2)]
            assert not np.array_equal(plain[0], plain[1]) or k == "loss_mask"
            for name in ("mesh", "shardings"):
                for r in range(2):
                    np.testing.assert_array_equal(got[r][f"{name}/{i}/{k}"],
                                                  plain[r])
                sharded = f"{name}/{i}/{k}/whole" in got[0]
                assert sharded == (name == "mesh" or k == "tokens")
                if sharded:
                    for r in range(2):
                        np.testing.assert_array_equal(
                            got[r][f"{name}/{i}/{k}/whole"],
                            np.concatenate(plain))
