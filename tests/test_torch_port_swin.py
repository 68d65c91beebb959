"""Swin-T as the port's stage-2 regressor (``models/swin.py``) and kernel
K8 (``ops/attention.py``, ``kernels/csrc/window_attn.cu``).

On the CPU the port is held to the plain float32 reference of
``torch_port_swin_reference.py`` (written from the paper and the official
code, no module of the port) at a small size that keeps the published
structure: a 224² input, embed 32, depths 2-2-2-2, heads 1-2-4-8 (32
channels a head, as Swin-T), window 7, so stages of 56², 28², 14² and 7²,
shifted blocks in the first three and a last stage of one window.  The
eval forward, the training loss and every gradient, with stochastic depth
off and at 0.2 (both drawing their masks from one seeded generator), the
shift mask and the relative index against hand-worked values, the
benchmark's frozen copy of the reference, the stage spans, and Swin-T
built and trained through the port's normal path.

On the card (``-m cuda``, skipped elsewhere) K8 is held to its plain
version at the four stage shapes of Swin-T at 256 crops, shifted and not,
the wrapper refuses what K8 cannot take, and a graphed ``infer_batch`` of
the Swin build is held to its eager path bit for bit.  This file imports
no JAX, so on the machine with the card it runs without the repo's
conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_port_swin.py
"""

import os.path as osp

import numpy as np
import pytest
import torch

import torch_port_swin_reference as R
from tpudet3d_torch.core import read_py_config
from tpudet3d_torch.losses import LossManager, build_loss
from tpudet3d_torch.models import MultiHeadRegressor, SwinTransformer, swin
from tpudet3d_torch.models.builder import build_backbone, build_model
from tpudet3d_torch.ops import attention
from tpudet3d_torch.utils import profiling

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
CONFIG = osp.join(REPO, 'configs', 'scene_regressor_swint.py')
SMALL = dict(embed_dim=32, depths=(2, 2, 2, 2), heads=(1, 2, 4, 8),
             window=7)
TINY = 'swin_tiny_patch4_window7_224'
STAGES = [f'tpudet3d_torch.swin.stage{i}' for i in range(1, 5)]
# Both sides compute in float32 and differ only in the order of some sums
# (the heads' einsum against addmm, the attention's reshapes): measured
# 0 here, a float32 rounding of the largest value allowed.  Leaving out
# the bias moves the pre-activations by 0.28 and the logits by 0.22 at
# these weights, the mask 0.15 and 0.08, the shift at stage 4 0.039 and
# 0.024 (asserted below against these tolerances).
FWD_RTOL = 1e-5            # of the largest magnitude of each output
# Loss and gradients through 8 blocks and their backward: float32
# rounding in another order, measured up to 1.8e-6 of a leaf's largest
# gradient.
LOSS_TOL = 1e-5
GRAD_RTOL = 2e-5           # of each leaf's largest gradient


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def draw(model, seed, table_std=1.0):
    """Seeded float32 weights by leaf kind: LayerNorm scales U(0.5, 1.5),
    convs N(0, √(2/fan_in)), dense and head kernels N(0, 1/√fan_in), the
    bias tables N(0, ``table_std``) (large enough that the bias decides
    part of the answer), every other leaf N(0, 0.1)."""
    rng = np.random.RandomState(seed)
    sd = {}
    for k, v in model.state_dict().items():
        s = tuple(v.shape)
        if 'norm' in k and k.endswith('weight'):
            a = rng.uniform(0.5, 1.5, s)
        elif k.endswith('relative_position_bias_table'):
            a = rng.normal(0.0, table_std, s)
        elif k.endswith('head_kernel'):
            a = rng.normal(0.0, 1.0 / np.sqrt(s[1]), s)
        elif v.dim() == 4:
            a = rng.normal(0.0, np.sqrt(2.0 / np.prod(s[1:])), s)
        elif v.dim() == 2:
            a = rng.normal(0.0, 1.0 / np.sqrt(s[1]), s)
        else:
            a = rng.normal(0.0, 0.1, s)
        sd[k] = torch.tensor(a, dtype=torch.float32)
    return sd


def crops(n=3, seed=1):
    return torch.tensor(np.random.RandomState(seed).standard_normal(
        (n, 224, 224, 3)), dtype=torch.float32)


def pair(rate=0.0, seed=0):
    """The port's small Swin regressor and the reference, one state."""
    port = MultiHeadRegressor(SwinTransformer(**SMALL, drop_path_rate=rate))
    ref = R.Regressor(**SMALL, drop_path_rate=rate)
    sd = draw(port, seed)
    port.load_state_dict(sd)
    ref.load_state_dict(sd)
    return port, ref


def gaps(port, ref, x):
    """The port's eval forward against the reference's: the largest gap
    of the pre-activations and of the logits over their tolerances."""
    with torch.no_grad():
        pk, pl = port(x, pre_activation=True)
        rk, rl = ref(x)
    return ((pk - rk).abs().max() / (FWD_RTOL * rk.abs().max())).item(), \
        ((pl - rl).abs().max() / (FWD_RTOL * rl.abs().max())).item()


def test_eval_forward_matches_the_reference():
    port, ref = pair()
    assert max(gaps(port.eval(), ref.eval(), crops())) <= 1.0


def plant_no_bias(setattr):
    real = swin.window_attention
    setattr(swin, 'window_attention',
            lambda qkv, table, *a, **k: real(qkv, None, *a, **k))


def plant_no_mask(setattr):
    real = swin.window_attention
    setattr(swin, 'window_attention',
            lambda *a, **k: real(*a, **dict(k, masked=False)))


def plant_shift_at_stage4(setattr):
    setattr(swin, 'block_shift', lambda index, resolution, window:
            window // 2 if index % 2 else 0)


@pytest.mark.parametrize('plant', [plant_no_bias, plant_no_mask,
                                   plant_shift_at_stage4],
                         ids=['no_bias', 'no_mask', 'shift_at_stage4'])
def test_the_tolerances_see_each_fault(monkeypatch, plant):
    """Leaving out the bias or the shift mask, or shifting the last
    stage's one window, moves an output beyond its tolerance by far."""
    port, ref = pair()
    plant(monkeypatch.setattr)
    assert max(gaps(port.eval(), ref.eval(), crops())) > 100.0


def _loss_manager():
    cfg = read_py_config(CONFIG)
    return LossManager(build_loss(cfg), cfg.loss.coeffs, cfg.loss.alwa)


@pytest.mark.parametrize('rate', [0.0, 0.2], ids=['no_drop', 'drop0.2'])
def test_training_loss_and_gradients_match_the_reference(rate):
    """Training mode (stochastic depth at ``rate`` and the classifier's
    dropout, masks from one seeded generator on each side), the
    configuration's loss, and the gradient of every leaf."""
    port, ref = pair(rate)
    x = crops()
    rng = np.random.RandomState(2)
    gt = torch.tensor(rng.uniform(0.2, 0.8, (3, 9, 2)), dtype=torch.float32)
    cats = torch.tensor([0, 4, 8])
    lm = _loss_manager()
    kp, logits = port(x, cats=cats, train=True,
                      generator=torch.Generator().manual_seed(7))
    loss, _ = lm.parse_losses(kp, gt, logits, cats, 0, lm.init_state())
    loss.backward()
    rkp, rlogits = ref(x, cats=cats, train=True,
                       generator=torch.Generator().manual_seed(7))
    rloss = R.loss(rkp, gt, rlogits, cats)
    rloss.backward()
    assert abs(loss.item() - rloss.item()) <= LOSS_TOL * abs(rloss.item())
    own = dict(port.named_parameters())
    assert set(own) == {k for k, _ in ref.named_parameters()}
    for k, p in ref.named_parameters():
        scale = p.grad.abs().max()
        assert scale > 0, k
        assert (own[k].grad - p.grad).abs().max() <= GRAD_RTOL * scale, k
    if rate:
        # the masks were drawn: the loss is not the one without them
        port0, _ = pair(0.0)
        kp0, lg0 = port0(x, cats=cats, train=True,
                         generator=torch.Generator().manual_seed(7))
        loss0, _ = lm.parse_losses(kp0, gt, lg0, cats, 0, lm.init_state())
        assert abs(loss0.item() - loss.item()) > 100 * LOSS_TOL


def test_drop_path_rates_and_draws():
    """Rates grow linearly from 0 over the blocks; the first block draws
    nothing, every other one draws one uniform a row per branch."""
    m = SwinTransformer(**SMALL, drop_path_rate=0.2)
    rates = [b.drop_path_rate for s in m.layers for b in s.blocks]
    assert rates[0] == 0.0 and rates[-1] == pytest.approx(0.2)
    assert np.allclose(np.diff(rates), 0.2 / 7, atol=1e-7)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        m.features(crops(2).permute(0, 3, 1, 2), True, g)
    expect = torch.Generator().manual_seed(0)
    torch.rand((2 * 2 * 7,), generator=expect)
    assert torch.equal(torch.rand(4, generator=g),
                       torch.rand(4, generator=expect))


def test_training_takes_the_plain_attention_and_serving_the_wrapper(
        monkeypatch):
    """K8 has no backward: the blocks call ``window_attention_plain`` in
    training mode and ``window_attention`` (K8 on the card) otherwise, a
    call a block either way."""
    calls = []
    for name in ('window_attention', 'window_attention_plain'):
        real = getattr(swin, name)
        monkeypatch.setattr(swin, name, lambda *a, _n=name, _f=real, **k:
                            calls.append(_n) or _f(*a, **k))
    port, _ = pair()
    x = crops(1)
    with torch.no_grad():
        port(x, pre_activation=True)
    assert calls == ['window_attention'] * 8
    calls.clear()
    port(x, cats=torch.tensor([2]), train=True,
         generator=torch.Generator().manual_seed(0))
    assert calls == ['window_attention_plain'] * 8


def test_shift_mask_and_relative_index_by_hand():
    """A 14×14 map, window 7, shift 3: rows and columns 0-6 are region 0,
    7-10 region 1, 11-13 region 2 of their axis."""
    r = attention.shift_regions(14, 14, 7, 3)
    assert r[0, 0] == 0 and r[7, 10] == 4 and r[11, 0] == 6 \
        and r[13, 13] == 8 and r[10, 11] == 5
    mask = attention.shift_mask(14, 14, 7, 3)
    assert mask.shape == (4, 49, 49)
    masked = (mask == attention.MASK_VALUE).sum((1, 2)).tolist()
    # window (0,0) one region; (0,1) columns 4 | 3 → 2·28·21; (1,0)
    # likewise by rows; (1,1) groups of 16, 12, 12, 9 → 49² − 625
    assert masked == [0, 1176, 1176, 1776]
    assert set(mask.unique().tolist()) == {0.0, attention.MASK_VALUE}
    assert mask[1, 0, 3] == 0 and mask[1, 0, 4] == attention.MASK_VALUE
    assert mask[2, 0, 27] == 0 and mask[2, 0, 28] == attention.MASK_VALUE
    # window (1,1): token 24 at (3,3) shares token 0's group, (3,4) and
    # (4,0) do not
    assert mask[3, 0, 24] == 0 and mask[3, 0, 25] == attention.MASK_VALUE \
        and mask[3, 0, 28] == attention.MASK_VALUE
    assert torch.equal(mask, R.attention_mask(14, 14, 7, 3))
    idx = attention.relative_index(7)
    assert idx.shape == (49, 49)
    assert idx[0, 0] == 84 and idx[0, 48] == 0 and idx[48, 0] == 168
    assert idx[3, 10] == 71        # (0,3) against (1,3): (0-1+6)·13 + 6
    assert idx[10, 3] == 97        # (1,3) against (0,3): (1-0+6)·13 + 6
    assert torch.equal(idx, R.relative_position_index(7))


@pytest.mark.parametrize('shift', [0, 3])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_the_plain_version_against_the_reference_attention(shift, dtype):
    """``window_attention_plain`` on a 14×14 map against the reference's
    roll, partition, bias, mask and reverse around the attention of each
    window and head; in bfloat16 within the rounding of its output and of
    the probabilities (two ulps of 2^-7 of the largest value)."""
    rng = np.random.RandomState(shift)
    qkv = torch.tensor(rng.standard_normal((2, 14, 14, 3 * 64)),
                       dtype=torch.float32).to(dtype)
    table = torch.tensor(rng.normal(0, 1, (169, 2)), dtype=torch.float32)
    out = attention.window_attention(qkv, table, 2, 7, shift)
    assert out.dtype == dtype and out.shape == (2, 14, 14, 64)
    q = qkv.float()
    if shift:
        q = torch.roll(q, (-shift, -shift), (1, 2))
    win = R.window_partition(q, 7).view(-1, 49, 3, 2, 32) \
        .permute(2, 0, 3, 1, 4)
    att = (win[0] @ win[1].transpose(-2, -1)) * 32 ** -0.5 \
        + table[R.relative_position_index(7).view(-1)].view(49, 49, 2) \
        .permute(2, 0, 1)[None]
    if shift:
        att = (att.view(2, 4, 2, 49, 49)
               + R.attention_mask(14, 14, 7, shift)[None, :, None]) \
            .view(8, 2, 49, 49)
    o = (att.softmax(-1) @ win[2]).transpose(1, 2).reshape(-1, 7, 7, 64)
    ref = R.window_reverse(o, 7, 14, 14)
    if shift:
        ref = torch.roll(ref, (shift, shift), (1, 2))
    tol = 1e-5 if dtype == torch.float32 else 2 ** -6
    assert (out.float() - ref).abs().max() <= tol * ref.abs().max()


def test_the_benchmark_copy_matches_the_reference(monkeypatch):
    """``perfbench/reference/backbone_swin_tiny_patch4_window7_224.py``,
    the benchmark's frozen copy, gives the repo reference's pooled
    features on one seed at Swin-T's published widths."""
    monkeypatch.syspath_prepend(osp.join(REPO, 'perfbench'))
    from reference import models as bench
    reg = bench.MultiHeadRegressor(TINY)
    ref = R.Regressor()
    sd = draw(ref, 4, table_std=0.5)
    ref.load_state_dict(sd)
    reg.load_state_dict(sd)
    x = crops(2, seed=5)
    with torch.no_grad():
        a = ref.backbone(x.permute(0, 3, 1, 2))
        b = reg.backbone.features(x.permute(0, 3, 1, 2)).mean(dim=(2, 3))
        rk, rl = ref(x)
        bk, bl = reg(x)
    assert torch.allclose(a, b, rtol=0, atol=1e-5 * a.abs().max())
    assert torch.allclose(rk, bk, rtol=0, atol=1e-5 * rk.abs().max())
    assert torch.allclose(rl, bl, rtol=0, atol=1e-5 * rl.abs().max())


def test_stage_spans_under_a_profiler_and_none_without():
    """An eager forward under the profiler opens ``swin.stage1`` …
    ``stage4`` once each, in order, nested in nothing of the backbone's;
    with no profiler ``annotate`` stays the shared no-op."""
    m = SwinTransformer(**SMALL).eval()
    x = crops(1).permute(0, 3, 1, 2)
    made = []
    real = torch.profiler.record_function

    def spy(name, *args):
        made.append(name)
        return real(name, *args)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.profiler, 'record_function', spy)
        with torch.no_grad():
            m.features(x)
        assert made == []
        assert profiling.annotate(STAGES[0]) is profiling.annotate('x')
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof, \
                torch.no_grad():
            m.features(x)
    assert made == STAGES
    events = [e for e in prof.events()
              if e.name.startswith('tpudet3d_torch.swin.')]
    events.sort(key=lambda e: e.time_range.start)
    assert [e.name for e in events] == STAGES
    for a, b in zip(events, events[1:]):
        assert a.time_range.end <= b.time_range.start


def test_swin_t_builds_at_published_widths():
    m = build_backbone(TINY)
    assert m.feature_dim == 768 and m.drop_path_rate == 0.0
    assert [len(s.blocks) for s in m.layers] == [2, 2, 6, 2]
    assert [s.blocks[0].attn.heads for s in m.layers] == [3, 6, 12, 24]
    assert m.patch_embed.proj.out_channels == 96
    assert [swin.block_shift(j, r, 7) for r, d in zip((56, 28, 14, 7),
                                                      (2, 2, 6, 2))
            for j in range(d)] == [0, 3, 0, 3, 0, 3, 0, 3, 0, 3, 0, 0]
    n = sum(p.numel() for p in m.parameters())
    assert 27_500_000 < n < 27_600_000      # Swin-T without its 1000 classes
    with pytest.raises(ValueError, match='no stochastic depth'):
        build_backbone('efficientnet-lite0', drop_path_rate=0.1)


def test_the_config_trains_swin_t_through_the_train_step():
    """``configs/scene_regressor_swint.py`` through ``create_train_state``
    and ``make_train_step`` (float32 on the CPU, batch 2): the leaves and
    the EMA move, the loss is finite, and no batch-norm statistics exist
    to carry."""
    from tpudet3d_torch.train import create_train_state, make_train_step
    cfg = read_py_config(CONFIG)
    cfg.model.update(bf16=False)
    state = create_train_state(cfg, device='cpu',
                               generator=torch.Generator().manual_seed(0))
    m = state.model
    assert isinstance(m.backbone, SwinTransformer)
    assert m.backbone.drop_path_rate == pytest.approx(0.2)
    assert not any(isinstance(x, torch.nn.modules.batchnorm._BatchNorm)
                   for x in m.modules())
    assert state.optimizer.param_groups[0]['weight_decay'] == 0.05
    table = m.backbone.layers[0].blocks[0].attn.relative_position_bias_table
    assert 0.01 < float(table.detach().std()) < 0.03         # the official init
    step = make_train_step(m, state.loss_manager, state.optimizer,
                           ema_decay=state.ema_decay)
    rng = np.random.RandomState(3)
    imgs = crops(2, seed=6)
    kp = torch.tensor(rng.uniform(0.2, 0.8, (2, 9, 2)), dtype=torch.float32)
    cats = torch.tensor([1, 5])
    before = {k: p.detach().clone() for k, p in m.named_parameters()}
    ema = {k: v.clone() for k, v in state.ema_params.items()}
    state, metrics = step(state, imgs, kp, cats,
                          torch.Generator().manual_seed(0))
    assert torch.isfinite(metrics).all()
    moved = [k for k, p in m.named_parameters()
             if not torch.equal(p, before[k])]
    assert len(moved) == len(before)
    assert not torch.equal(state.ema_params[moved[0]], ema[moved[0]])
    assert int(state.step) == 1


def test_build_model_serves_bf16_from_the_config():
    cfg = read_py_config(CONFIG)
    m = build_model(cfg)
    assert m.dtype == torch.bfloat16 and m.backbone.feature_dim == 768
    with torch.no_grad():
        pre, logits = m(crops(1), pre_activation=True)
    assert pre.shape == (1, 9, 18) and pre.dtype == torch.float32
    assert logits.dtype == torch.bfloat16 and torch.isfinite(pre).all()


# --- on the card -----------------------------------------------------------

# Swin-T's four stages at 256 crops: (map side, heads)
STAGE_SHAPES = [(56, 3), (28, 6), (14, 12), (7, 24)]


@pytest.fixture(scope='module')
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU and nvcc')
    return torch.device('cuda')


def _exact(qkv, table, heads, shift, masked):
    """The function in float64 from the same bf16 inputs."""
    return attention.window_attention_plain(
        qkv.double(), None if table is None else table.double(), heads, 7,
        shift, masked)


@pytest.mark.cuda
@pytest.mark.parametrize('shift', [0, 3])
@pytest.mark.parametrize('side, heads', STAGE_SHAPES)
def test_k8_matches_the_plain_version_on_card(card, side, heads, shift):
    """K8 against ``window_attention_plain`` on the same bf16 qkv at 256
    crops: within two bf16 ulps of the output's largest magnitude (the two
    differ in the order of their float32 sums, which can move a
    probability across a bf16 rounding and the output by an ulp), and as
    close to the float64 function as the plain version is."""
    g = torch.Generator(device=card).manual_seed(side + shift)
    qkv = (2 * torch.randn((256, side, side, 3 * 32 * heads), generator=g,
                           device=card)).to(torch.bfloat16)
    table = torch.randn((169, heads), generator=g, device=card)
    before = attention.window_attention.launches
    with torch.no_grad():
        out = attention.window_attention(qkv, table, heads, 7, shift)
    torch.cuda.synchronize()
    assert attention.window_attention.launches == before + 1
    plain = attention.window_attention_plain(qkv, table, heads, 7, shift)
    scale = plain.float().abs().max()
    gap = (out.float() - plain.float()).abs().max()
    assert gap <= 2 * 2 ** -7 * scale, (gap, scale)
    n = 16                  # the float64 comparison on the first crops
    exact = _exact(qkv[:n], table, heads, shift, shift > 0)
    k8_err = (out[:n].double() - exact).abs().max()
    plain_err = (plain[:n].double() - exact).abs().max()
    assert k8_err <= 1.5 * plain_err + 1e-6, (k8_err, plain_err)


@pytest.mark.cuda
@pytest.mark.parametrize('what', ['float32', 'head_size', 'window',
                                  'needs_grad'])
def test_k8_refuses_what_it_cannot_take_on_card(card, what):
    """On the card the wrapper launches K8 or raises: it never hands a
    CUDA tensor to the plain version."""
    g = torch.Generator(device=card).manual_seed(3)
    side, heads, d, window = 14, 2, 32, 7
    if what == 'head_size':
        d = 16
    if what == 'window':
        side, window = 18, 9
    qkv = torch.randn((2, side, side, 3 * d * heads), generator=g,
                      device=card)
    if what != 'float32':
        qkv = qkv.to(torch.bfloat16)
    table = torch.randn(((2 * window - 1) ** 2, heads), generator=g,
                        device=card, requires_grad=what == 'needs_grad')
    before = attention.window_attention.launches
    with pytest.raises(ValueError):
        attention.window_attention(qkv, table, heads, window, 3)
    assert attention.window_attention.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize('what', ['no_bias', 'no_mask', 'shift_at_stage4'])
def test_k8_faults_on_card(card, what):
    """K8 without its table, without its mask, and shifted on the last
    stage's one window, against the plain version of the same call."""
    g = torch.Generator(device=card).manual_seed(5)
    side, heads = (7, 24) if what == 'shift_at_stage4' else (14, 12)
    qkv = torch.randn((8, side, side, 3 * 32 * heads), generator=g,
                      device=card).to(torch.bfloat16)
    table = torch.randn((169, heads), generator=g, device=card)
    args = dict(no_bias=(None, 3, True), no_mask=(table, 3, False),
                shift_at_stage4=(table, 3, True))[what]
    with torch.no_grad():
        out = attention.window_attention(qkv, args[0], heads, 7, args[1],
                                         args[2])
    plain = attention.window_attention_plain(qkv, *args[:1], heads, 7,
                                             *args[1:])
    sound = attention.window_attention_plain(qkv, table, heads, 7,
                                             0 if side == 7 else 3)
    scale = plain.float().abs().max()
    assert (out.float() - plain.float()).abs().max() <= 2 * 2 ** -7 * scale
    assert (out.float() - sound.float()).abs().max() > 0.1 * scale


@pytest.mark.cuda
def test_graphed_swin_rows_equal_eager_on_card(card):
    """``build_engine`` on the Swin-T config: the captured and replayed
    ``infer_batch`` rows bit for bit the eager ``_pipeline_batch``'s, K8
    launched by the eager path, and a replay's device trace holding K8."""
    from torch.profiler import ProfilerActivity, profile
    from tpudet3d_torch.infer import build_engine
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        engine = build_engine(CONFIG, det_conf=0.0, device=card)
        frames = np.random.RandomState(0).randint(
            0, 256, (8, 720, 1280, 3)).astype(np.uint8)
        h, w = frames.shape[1:3]
        launches = attention.window_attention.launches
        eager = engine._pipeline_batch(engine._upload(frames), h, w)
        assert attention.window_attention.launches == launches + 12
        first = engine.infer_batch(frames)
        for _ in range(2):
            engine.infer_batch(frames)
            (g,) = engine._graphs.values()
            assert torch.equal(g.static_out, eager)
        assert engine.graph_stats == {'captures': 1, 'replays': 2,
                                      'eager': 0}
        assert len(first) == 8 and all(len(r['scores']) == 8 for r in first)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            engine.infer_batch(frames)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        assert sum('window_attn_kernel' in n for n in names) == 12
    finally:
        torch.backends.cudnn.deterministic = before
