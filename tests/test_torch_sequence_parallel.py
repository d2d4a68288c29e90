"""The port's sequence-parallel SaP-scans (``repro_torch.models.
sequence_parallel``) against the JAX package's sequential oracles and the
port's single-process scans.

Four processes on the CPU in one gloo group (started once for the module
by ``spawn_ranks``) each take their slice of T, run ``sp_ssd`` /
``sp_wkv6`` and return it; the whole output and the last shard's state are
held against ``repro.kernels.ref.ssd_ref`` / ``wkv6_ref`` at the full T,
in this process, within 5e-4 (``tests/test_sequence_parallel.py``'s own
limit: the cross-shard carry is exact, and the sums are the same float32
recurrence in another order), and against the port's single-process
``ops.ssd`` / ``ops.wkv6`` at the full T within the same limit.  The
shapes are that test's: B = 2, H = 2, T = 256, N = 8, P = 16, D = 16.

Two decay strengths.  "strong" is the JAX test's, log decays
-exp(0.5 normal) (about -1.1 a step): a shard's total decay underflows to
0, so only the last hop of the carry chain reaches a rank.  "weak" scales
the same draws by 1e-3, so a shard of 64 steps keeps ~0.93 of its state:
every step of the P-1-step chain, with its decay multiply, is in the
result.  Both are held to the same 5e-4.

Meshes: (4,) split along "data"; (2, 2) split along both axes (four
shards, row-major); (2, 2) split along "model" only (two shards of T,
repeated on each "data" row).
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops

B, H, T, N, PD, D = 2, 2, 256, 8, 16, 16
LIMIT = 5e-4
DECAYS = {"strong": 1.0, "weak": 1e-3}
MESHES = {"data4": ((4,), ("data",), ("data",)),
          "both2x2": ((2, 2), ("data", "model"), ("data", "model")),
          "model2x2": ((2, 2), ("data", "model"), ("model",))}


def _inputs(decay="strong"):
    """The JAX test's inputs, in its order from one seeded generator, with
    the log decays scaled by ``DECAYS[decay]``."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(B, H, T, PD)).astype(np.float32)
    bm = rng.normal(size=(B, H, T, N)).astype(np.float32)
    cm = rng.normal(size=(B, H, T, N)).astype(np.float32)
    la = (-np.exp(rng.normal(size=(B, H, T)).astype(np.float32) * 0.5)).astype(np.float32)
    r = rng.normal(size=(B, H, T, D)).astype(np.float32)
    k = rng.normal(size=(B, H, T, D)).astype(np.float32)
    v = rng.normal(size=(B, H, T, D)).astype(np.float32)
    lw = (-np.exp(rng.normal(size=(B, H, T, D)).astype(np.float32) * 0.5)).astype(np.float32)
    u = rng.normal(size=(H, D)).astype(np.float32)
    scale = np.float32(DECAYS[decay])
    return {"ssd": (x, bm, cm, la * scale), "wkv": (r, k, v, lw * scale, u)}


def _ranks_body():
    """Every mesh's two scans, at both decays, on this rank's slice of T."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.sequence_parallel import sp_ssd, sp_wkv6

    torch.set_num_threads(1)
    out = {}
    for decay in DECAYS:
        inp = {nm: tuple(torch.from_numpy(a) for a in t) for nm, t in _inputs(decay).items()}
        for name, (shape, axes, seq) in MESHES.items():
            mesh = make_test_mesh(shape, axes, device="cpu")
            shards, idx = mesh.axis_size(seq), mesh.axis_index(seq)
            t_loc = T // shards
            sl = slice(idx * t_loc, (idx + 1) * t_loc)
            x, bm, cm, la = inp["ssd"]
            y, s = sp_ssd(mesh, seq)(x[:, :, sl], bm[:, :, sl], cm[:, :, sl], la[:, :, sl])
            r, k, v, lw, u = inp["wkv"]
            o, w = sp_wkv6(mesh, seq)(r[:, :, sl], k[:, :, sl], v[:, :, sl], lw[:, :, sl], u)
            out[(decay, name)] = {"idx": idx, "last": idx == shards - 1,
                                  "ssd": (y, s[0]), "wkv": (o, w[0])}
    gathered = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, out)
    return gathered if dist.get_rank() == 0 else None


@pytest.fixture(scope="module")
def shards():
    from repro_torch.launch.mesh import spawn_ranks

    return spawn_ranks(_ranks_body, 4, timeout=240)[0]


@pytest.fixture(scope="module")
def references():
    """(JAX oracle, port single process) outputs and final states at full T,
    for each decay."""
    import jax.numpy as jnp

    from repro.kernels import ref as jref

    out = {}
    for decay in DECAYS:
        inp = _inputs(decay)
        x, bm, cm, la = inp["ssd"]
        r, k, v, lw, u = inp["wkv"]
        jax_out = {
            "ssd": jref.ssd_ref(*map(jnp.asarray, (x, bm, cm, la)),
                                jnp.zeros((B, H, N, PD), jnp.float32)),
            "wkv": jref.wkv6_ref(*map(jnp.asarray, (r, k, v, lw, u)),
                                 jnp.zeros((B, H, D, D), jnp.float32)),
        }
        t = lambda a: torch.from_numpy(a)  # noqa: E731
        port = {
            "ssd": ops.ssd(t(x), t(bm), t(cm), t(la), torch.zeros(B, H, N, PD)),
            "wkv": ops.wkv6(t(r), t(k), t(v), t(lw), t(u), torch.zeros(B, H, D, D)),
        }
        out[("jax", decay)] = {nm: tuple(np.asarray(a) for a in o) for nm, o in jax_out.items()}
        out[("port", decay)] = {nm: tuple(a.numpy() for a in o) for nm, o in port.items()}
    return out


def _assembled(shards, decay, mesh, scan):
    """The whole output from the shards (in order along the split axes) and
    the last shard's state."""
    rows = {}
    state = None
    for rank_out in shards:
        got = rank_out[(decay, mesh)]
        rows[got["idx"]] = got[scan][0].numpy()
        if got["last"]:
            state = got[scan][1].numpy()
    return np.concatenate([rows[i] for i in sorted(rows)], axis=2), state


def _check_against_full_sequence(shards, references, decay, mesh, scan, against):
    y, s = _assembled(shards, decay, mesh, scan)
    want_y, want_s = references[(against, decay)][scan]
    assert y.shape == want_y.shape and s.shape == want_s.shape
    assert float(np.abs(y - want_y).max()) < LIMIT
    assert float(np.abs(s - want_s).max()) < LIMIT


@pytest.mark.parametrize("against", ("jax", "port"))
@pytest.mark.parametrize("scan", ("ssd", "wkv"))
@pytest.mark.parametrize("mesh", MESHES)
def test_sequence_parallel_scan_matches_the_full_sequence(shards, references, mesh, scan, against):
    _check_against_full_sequence(shards, references, "strong", mesh, scan, against)


@pytest.mark.parametrize("against", ("jax", "port"))
@pytest.mark.parametrize("scan", ("ssd", "wkv"))
@pytest.mark.parametrize("mesh", MESHES)
def test_weak_decay_carries_the_whole_chain(shards, references, mesh, scan, against):
    _check_against_full_sequence(shards, references, "weak", mesh, scan, against)


def test_shards_on_other_data_rows_agree(shards):
    """Split along "model" only, the two "data" rows compute the same
    shards: ranks 0 / 2 and 1 / 3 return equal outputs."""
    for a, b in ((0, 2), (1, 3)):
        for scan in ("ssd", "wkv"):
            for ta, tb in zip(shards[a][("strong", "model2x2")][scan],
                              shards[b][("strong", "model2x2")][scan]):
                torch.testing.assert_close(ta, tb, rtol=0, atol=0)
