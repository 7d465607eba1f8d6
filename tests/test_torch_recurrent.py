"""The port's recurrent blocks and windowed attention against the JAX
package, at `.reduced()` on the CPU.

Blocks (`repro_torch.models.recurrent` against `repro.models.recurrent`):
`rglru_block` (recurrentgemma-2b), `mlstm_block` and `slstm_block`
(xlstm-1.3b), with JAX-initialised weights (`params_from_jax`) and the
same numpy-seeded bf16 inputs, through three stages: a prefill from the
initial state, a prefill from that state with trailing pads, and a T = 1
decode step; the mLSTM also at S = 150 (two chunks of 128, the second
padded).  Each stage starts from JAX's state, so the stages' errors do
not add up.  Tolerances: the bf16 outputs within 2e-2 + 2^-7 |want| (a
bf16 ulp of the output, plus the f32 summation order carried through
the last bf16 product); f32 states within 1e-4 + 1e-4 |want| — the
RG-LRU scan sums in another tree order than `jax.lax.associative_scan`,
the mLSTM's einsums contract in another order; the conv state is bf16
and equal bit for bit.

Windowed attention (recurrentgemma's local window, 32 at `.reduced()`):
the ring buffer a prefill and a decode step write, `_windowed_attention`
called directly at S = 96 and reached through `attention` at S = 1100
(> 1024, > 2 x window), within 2e-2 of JAX's.

flash_decode at recurrentgemma-2b's decode heads (hd 256, MQA at G = 10)
with a window shorter than Sk: the port's plain version against the JAX
package's Pallas body in interpret mode (f32, 2e-5), and the card
kernel's schedule (tests/decode_schedule.py, the heads cut into two
chunks of 5, one cluster each) against both.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from decode_schedule import decode_schedule
from repro.configs import get_config
from repro.kernels import ops as jops
from repro.models import attention as jattn
from repro.models import recurrent as jrec
from repro.models.transformer import init_params as jinit
from repro.models.transformer import make_model as jmake
from repro_torch.configs import get_config as tget
from repro_torch.kernels import ops as tops
from repro_torch.models import attention as tattn
from repro_torch.models import recurrent as trec
from repro_torch.models.convert import params_from_jax, tensor_from_numpy
from repro_torch.models.transformer import init_params as tinit
from repro_torch.models.transformer import make_model as tmake

torch.set_num_threads(1)

BLOCKS = {"rglru": "recurrentgemma-2b", "mlstm": "xlstm-1.3b",
          "slstm": "xlstm-1.3b"}
SENTINEL = 2 ** 30


def _t(a):
    return tensor_from_numpy(np.asarray(a), "cpu")


def _close_out(got, want):
    g, w = got.float().numpy(), np.asarray(want).astype(np.float32)
    assert g.shape == w.shape and np.isfinite(g).all()
    assert (np.abs(g - w) <= 2e-2 + 2 ** -7 * np.abs(w)).all(), \
        np.abs(g - w).max()


def _close_state(got, want):
    for name, w in want.items():
        g = got[name]
        w = np.asarray(w)
        if w.dtype.name == "bfloat16":
            assert (g.view(torch.int16).numpy() == w.view(np.int16)).all(), \
                name
            continue
        g = g.numpy()
        assert g.shape == w.shape and np.isfinite(g).all(), name
        err = np.abs(g - w) - (1e-4 + 1e-4 * np.abs(w))
        assert (err <= 0).all(), (name, np.abs(g - w).max())


def _block(kind):
    cfg = get_config(BLOCKS[kind]).reduced()
    init = getattr(jrec, f"{kind}_init")
    p = init(jax.random.PRNGKey(7), cfg)
    return (cfg, tget(BLOCKS[kind]).reduced(), p,
            params_from_jax(jax.tree.map(np.asarray, p), device="cpu"))


def _x(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.normal(0, 1, (b, s, cfg.d_model)).astype(
        np.float32)).astype(jnp.bfloat16)


def _valid(lens, s):
    return np.arange(s)[None] < np.asarray(lens)[:, None]


@pytest.mark.parametrize("kind,s", [("rglru", 12), ("mlstm", 12),
                                    ("mlstm", 150), ("slstm", 12)])
def test_block_matches_jax(kind, s):
    """Prefill from the initial state, a prefill from that state with
    trailing pads, then one decode step from that state, each held
    against JAX's from JAX's state before it."""
    cfg, tcfg, jp, tp = _block(kind)
    jfn, tfn = getattr(jrec, f"{kind}_block"), getattr(trec, f"{kind}_block")
    jinit_state = getattr(jrec, f"init_{kind}_state")
    b = 3
    state = jinit_state(cfg, b)
    stages = [(_x(cfg, b, s, 1), np.ones((b, s), bool)),
              (_x(cfg, b, s, 2), _valid([s, s // 2, 3], s)),
              (_x(cfg, b, 1, 3), np.ones((b, 1), bool))]
    for x, valid in stages:
        want, wstate = jfn(x, jp, cfg, state, jnp.asarray(valid))
        tstate = {k: _t(v) for k, v in state.items()}
        got, gstate = tfn(_t(x), tp, tcfg, tstate, torch.tensor(valid))
        _close_out(got, want)
        _close_state(gstate, wstate)
        state = wstate


@pytest.mark.parametrize("kind", ["rglru", "mlstm", "slstm"])
def test_block_without_state_matches_jax(kind):
    """The training / forward form (no state; the RG-LRU's log-step scan
    against jax.lax.associative_scan), with pads in one lane."""
    cfg, tcfg, jp, tp = _block(kind)
    x, valid = _x(cfg, 2, 20, 4), _valid([20, 13], 20)
    want, none = getattr(jrec, f"{kind}_block")(x, jp, cfg, None,
                                                jnp.asarray(valid))
    got, tnone = getattr(trec, f"{kind}_block")(_t(x), tp, tcfg, None,
                                                torch.tensor(valid))
    assert none is None and tnone is None
    _close_out(got, want)


def test_pads_leave_the_state_alone():
    """A lane of pads only, from a state that has seen input (m = 0.5,
    not the initial -1e30): every block returns its state unchanged (the
    conv state aside, which the reference re-gathers from the inputs)
    and finite outputs, never NaN.  (From the initial m = -1e30 a pad
    adds k v to the mLSTM's C at weight exp(-1e30 + 1e30) = 1, as in the
    reference; the first real step scales that by exp(-1e30) = 0.)"""
    for kind in ("rglru", "mlstm", "slstm"):
        _, tcfg, _, tp = _block(kind)
        st = getattr(trec, f"init_{kind}_state")(tcfg, 2)
        st = {k: (torch.full_like(v, 0.5) if v.dtype == torch.float32
                  else v) for k, v in st.items()}
        x = _t(_x(tcfg, 2, 5, 5))
        y, new = getattr(trec, f"{kind}_block")(
            x, tp, tcfg, dict(st), torch.tensor(_valid([5, 0], 5)))
        assert torch.isfinite(y.float()).all(), kind
        for k, v in st.items():
            if k != "conv":
                assert torch.equal(new[k][1], v[1]), (kind, k)


def test_init_params_keeps_jax_layout():
    for arch in ("recurrentgemma-2b", "xlstm-1.3b"):
        cfg, tcfg = get_config(arch).reduced(), tget(arch).reduced()
        want = jax.eval_shape(lambda k: jinit(cfg, k), jax.random.PRNGKey(0))
        got = tinit(tcfg, seed=0, device="cpu")
        names = {"bfloat16": torch.bfloat16, "float32": torch.float32}
        flat = jax.tree_util.tree_flatten_with_path(want)[0]
        n = 0
        for path, leaf in flat:
            t = got
            for p in path:
                t = t[p.key]
            assert tuple(t.shape) == leaf.shape, (arch, path)
            assert t.dtype == names[str(leaf.dtype)], (arch, path)
            n += 1
        assert n == len(jax.tree_util.tree_leaves(got)), arch


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "xlstm-1.3b"])
def test_prefill_logits_match_jax(arch):
    """The whole model: bucketed prefill logits of JAX-initialised weights
    within 2e-2, then two decode steps of the active lanes."""
    cfg, tcfg = get_config(arch).reduced(), tget(arch).reduced()
    params = jinit(cfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    rng = np.random.default_rng(1)
    lens, s = [5, 16, 11], 16
    toks = np.zeros((3, s), np.int32)
    pos = np.full((3, s), SENTINEL, np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, cfg.vocab_size, n)
        pos[i, :n] = np.arange(n)
    last = np.asarray(lens) - 1
    jm, tm = jmake(cfg, remat=False), tmake(tcfg, device="cpu")
    want, jc = jm.prefill(params, jm.init_cache(3, s + 2),
                          tokens=jnp.asarray(toks),
                          positions=jnp.asarray(pos),
                          last_idx=jnp.asarray(last))
    got, tc = tm.prefill(tp, tm.init_cache(3, s + 2), torch.tensor(toks),
                         positions=torch.tensor(pos),
                         last_idx=torch.tensor(last))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-2,
                               rtol=0)
    act = np.array([True, False, True])
    for j in range(2):
        tok = rng.integers(0, cfg.vocab_size, 3).astype(np.int32)
        want, jc = jm.decode_step(params, jc, jnp.asarray(tok),
                                  active=jnp.asarray(act))
        got, tc = tm.decode_step(tp, tc, torch.tensor(tok),
                                 active=torch.tensor(act))
        # an inactive lane's logits are never read (the port's kernel
        # gives it zeros where the reference attends anyway)
        np.testing.assert_allclose(got.numpy()[act], np.asarray(want)[act],
                                   atol=2e-2, rtol=0, err_msg=f"step {j}")
    assert (tc["pos"].numpy() == np.asarray(jc["pos"])).all()


# -- windowed attention ------------------------------------------------------


def _attn_setup(seed=0):
    cfg = get_config("recurrentgemma-2b").reduced()
    tcfg = tget("recurrentgemma-2b").reduced()
    p = jattn.attn_init(jax.random.PRNGKey(seed), cfg)
    return cfg, tcfg, p, params_from_jax(jax.tree.map(np.asarray, p),
                                         device="cpu")


def test_ring_buffer_prefill_and_decode():
    """A 64-row bucket into a ring of 32 slots (the window): both keep the
    bucket's last 32 rows at arange(32, 64) % 32, kpos equal bit for bit
    and the written K/V rows within bf16 rounding; then decode steps
    write at qpos % 32 and attend within the window."""
    cfg, tcfg, jp, tp = _attn_setup()
    assert cfg.local_window == 32
    b, s = 2, 64
    lens = [40, 64]
    x = _x(cfg, b, s, 6)
    pos = np.where(_valid(lens, s), np.arange(s)[None], SENTINEL).astype(
        np.int32)
    jcache = jattn.init_attn_cache(cfg, b, s)
    tcache = tattn.init_attn_cache(tcfg, b, s)
    assert tuple(tcache["k"].shape) == tuple(jcache["k"].shape) == (
        b, 32, cfg.n_kv_heads, cfg.head_dim)
    want, jcache = jattn.attention(x, jp, cfg, jnp.asarray(pos),
                                   cache=jcache)
    got, tcache = tattn.attention(_t(x), tp, tcfg, torch.tensor(pos),
                                  cache=tcache)
    _close_out(got, want)
    kp = np.asarray(jcache["kpos"])
    assert (tcache["kpos"].numpy() == kp).all()
    assert kp[0].tolist() == list(range(32, 40)) + [SENTINEL] * 24
    live = kp < SENTINEL  # rows at pad positions hold RoPE(2^30): unread
    for name in ("k", "v"):
        g = tcache[name].float().numpy()[live]
        w = np.asarray(jcache[name]).astype(np.float32)[live]
        assert (np.abs(g - w) <= 2e-2 + 2 ** -7 * np.abs(w)).all(), name
    qpos = np.array([[40], [64]], np.int32)
    for step in range(3):
        xs = _x(cfg, b, 1, 10 + step)
        want, jcache = jattn.attention(xs, jp, cfg, jnp.asarray(qpos),
                                       cache=jcache)
        got, tcache = tattn.attention(_t(xs), tp, tcfg, torch.tensor(qpos),
                                      cache=tcache)
        _close_out(got, want)
        assert (tcache["kpos"].numpy() == np.asarray(jcache["kpos"])).all()
        assert tcache["kpos"][1, (64 + step) % 32] == 64 + step
        qpos = qpos + 1


def test_windowed_attention_direct():
    """`_windowed_attention` at window 32, S = 96, with pads, against
    JAX's."""
    cfg, _, _, _ = _attn_setup()
    rng = np.random.default_rng(8)
    b, s, h, kvh, hd = 2, 96, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = rng.normal(0, 1, (b, s, h, hd)).astype(np.float32) * hd ** -0.5
    k = rng.normal(0, 1, (b, s, kvh, hd)).astype(np.float32)
    v = rng.normal(0, 1, (b, s, kvh, hd)).astype(np.float32)
    pos = np.where(_valid([96, 70], s), np.arange(s)[None],
                   SENTINEL).astype(np.int32)
    want = jattn._windowed_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                     jnp.asarray(pos), jnp.asarray(pos), 32)
    got = tattn._windowed_attention(*(torch.tensor(a) for a in (q, k, v)),
                                    torch.tensor(pos), torch.tensor(pos), 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


def test_windowed_route_past_dense_max():
    """S = 1100 (> DENSE_ATTN_MAX_KV, > 2 x window) takes
    `_windowed_attention` in both, never flash_attention."""
    cfg, tcfg, jp, tp = _attn_setup(1)
    s = 1100
    x = _x(cfg, 1, s, 9)
    pos = np.arange(s, dtype=np.int32)[None]
    want, _ = jattn.attention(x, jp, cfg, jnp.asarray(pos),
                              pos_contiguous=True)
    tops.reset_launches()
    got, _ = tattn.attention(_t(x), tp, tcfg, torch.tensor(pos),
                             pos_contiguous=True)
    assert tops.launches["flash_attention"] == 0
    _close_out(got, want)


# -- flash_decode at recurrentgemma-2b's decode heads ------------------------


def test_flash_decode_hd256_group10_window():
    """hd 256, 10 query heads on 1 kv head, Sk 96 with a window of 40 and
    ring-buffer kpos (positions 20..115 at slot p % 96), lane 2
    inactive: the plain version against the Pallas body (interpret)
    and the jnp oracle in f32; the card's schedule (two head chunks of
    5) against the plain version."""
    rng = np.random.default_rng(11)
    b, kvh, g, hd, sk, window = 3, 1, 10, 256, 96, 40
    assert tops.decode_group_chunks(g) == [5, 5]
    q = rng.normal(0, 1, (b, kvh * g, hd)).astype(np.float32) * hd ** -0.5
    k = rng.normal(0, 1, (b, sk, kvh, hd)).astype(np.float32)
    v = rng.normal(0, 1, (b, sk, kvh, hd)).astype(np.float32)
    p = np.arange(20, 20 + sk)
    kpos = np.tile(np.roll(p, 20 % sk)[None], (b, 1)).astype(np.int32)
    kpos[1, 50:] = SENTINEL
    qpos = np.array([115, 60, 100], np.int32)
    active = np.array([True, True, False])
    args = (q, k, v, kpos, qpos)
    got = tops.flash_decode(*(torch.tensor(a) for a in args),
                            active=torch.tensor(active), window=window)
    for impl in ("interpret", "ref"):
        want = jops.flash_decode(*(jnp.asarray(a) for a in args),
                                 active=jnp.asarray(active), window=window,
                                 impl=impl)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                                   rtol=2e-5, err_msg=impl)
    assert (got[2] == 0).all()
    sched = decode_schedule(*(torch.tensor(a) for a in args),
                            active=torch.tensor(active), window=window)
    np.testing.assert_allclose(sched.numpy(), got.numpy(), atol=2e-5,
                               rtol=2e-5)
    # bf16, as the card runs it
    bf = [torch.tensor(a).to(torch.bfloat16) for a in (q, k, v)]
    want = tops.flash_decode(*bf, torch.tensor(kpos), torch.tensor(qpos),
                             active=torch.tensor(active), window=window)
    sched = decode_schedule(*bf, torch.tensor(kpos), torch.tensor(qpos),
                            active=torch.tensor(active), window=window)
    np.testing.assert_allclose(sched.float().numpy(), want.float().numpy(),
                               atol=2e-2, rtol=0)
