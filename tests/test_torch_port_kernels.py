"""Each CUDA kernel of the port against its plain PyTorch version, on the
card.  Skips where there is no card.  This file imports no JAX, so on the
machine with the card it runs without the repo's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_port_kernels.py

Tolerances: K1 f32 1e-5 and bf16 2^-8 (values in [0, 1]), on every shape
the port feeds it (chip_smoke.K1_CASES); K2 f32 1e-4 and bf16 2^-7 + 1e-4
(normalised values, fused multiply-adds in the kernel), on the box and
frame cases of chip_smoke.K2_CASES; K3 scores 1e-6 and boxes 1e-3 px (only
the box-vote sums are ordered differently); K4 kp 1e-6, boxes 1e-4 px,
labels exact, also at the crop counts and on the logits with NaNs and ties
of chip_smoke.K4_CASES; K5 1e-5 (kernel and plain version compute the same
float32 operations in the same order); K6 and K7 bit for bit on
chip_smoke.K6_CASES (each on its route) and K7_CASES, torch._int_mm equal
to the exact product, and the int8 conv through the kernels equal to it
through the plain versions.

The K1 shapes, the K2, K3, K6 and K7 cases and the K4 and K5 inputs come
from
chip_smoke.py, so these
tests, the card smoke and the CPU parity tests (tests/test_torch_port_eval.py,
tests/test_torch_port_box3d.py) check the same cases.  Run from the repo
root, which puts chip_smoke.py on the import path.
"""

import pytest
import torch

from tpudet3d_torch.detect import (decode_detections,
                                   decode_detections_plain, generate_anchors)
from tpudet3d_torch.infer.engine import REG_OFFSET, REG_SCALE
from tpudet3d_torch.infer.epilogue import head_epilogue, head_epilogue_plain
from tpudet3d_torch.ops import (crop_and_resize, crop_and_resize_plain,
                                resize_bilinear, resize_bilinear_plain)
from tpudet3d_torch.ops.box3d import (iou_oriented_boxes,
                                      iou_oriented_boxes_plain)
from tpudet3d_torch.ops import quant as qops
from chip_smoke import (K1_CASES, K1_TOLS, K2_CASES, K2_TOLS, K3_CASES,
                        K4_CASES, K4_REFINE, K6_CASES, K7_CASES, compare_k4,
                        k1_frames, k2_case, k3_case, k4_inputs, k5_exact_cases,
                        k5_fuzz_pairs, k6_input, k6_plan, k6_route,
                        k7_input, plain_quant)
from torch_port_inputs import assert_dets_match, frame_batch, random_boxes


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU and nvcc')
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('dtype,atol', K1_TOLS)
@pytest.mark.parametrize('case', [c[0] for c in K1_CASES])
def test_k1_kernel_matches_plain(cuda, case, dtype, atol):
    frames = k1_frames(case, cuda)
    out = resize_bilinear(frames, (300, 300), True, 1 / 255.0, dtype)
    ref = resize_bilinear_plain(frames, (300, 300), True, 1 / 255.0)
    torch.testing.assert_close(out.float(), ref, rtol=0, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype,atol', K2_TOLS)
@pytest.mark.parametrize('case', ['random'] + [c[0] for c in K2_CASES])
@pytest.mark.parametrize('mirror', [False, True])
def test_k2_kernel_matches_plain(cuda, mirror, case, dtype, atol):
    if case == 'random':
        frames = torch.from_numpy(frame_batch(2, 720, 1280)).to(cuda)
        boxes = torch.from_numpy(random_boxes(2, 8, 720, 1280)).to(cuda)
        out_hw = (224, 224)
    else:
        frames, boxes, out_hw = k2_case(case, cuda)
    args = (out_hw, True, REG_SCALE, REG_OFFSET, mirror)
    out = crop_and_resize(frames, boxes, *args, dtype=dtype)
    ref = crop_and_resize_plain(frames, boxes, *args)
    torch.testing.assert_close(out.float(), ref, rtol=0, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize('mirror', [False, True], ids=['tta_off', 'tta_on'])
def test_k2_kernel_288(cuda, mirror):
    """K2 at the r288 config's serving shape: 128 crops of 720p to 288²
    (18 bands of 16 rows), bf16 and f32, with TTA (the mirror) off and on."""
    frames, boxes, out_hw = k2_case('r288', cuda)
    assert out_hw == (288, 288) and boxes.shape[:2] == (16, 8)
    args = (out_hw, True, REG_SCALE, REG_OFFSET, mirror)
    ref = crop_and_resize_plain(frames, boxes, *args)
    for dtype, atol in K2_TOLS:
        out = crop_and_resize(frames, boxes, *args, dtype=dtype)
        assert out.shape == (128 * (1 + mirror), 288, 288, 3)
        torch.testing.assert_close(out.float(), ref, rtol=0, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize('case', [c[0] for c in K3_CASES])
def test_k3_kernel_matches_plain(cuda, case):
    logits, deltas, kw = k3_case(case, cuda)
    anchors = torch.from_numpy(generate_anchors()).to(cuda)
    out = decode_detections(logits, deltas, anchors, **kw)
    ref = decode_detections_plain(logits, deltas, anchors, **kw)
    assert_dets_match(out.cpu().numpy(), ref.cpu().numpy(), box_atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize('logits_dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('mode', ['refine', 'pack'])
@pytest.mark.parametrize('tta', [False, True])
def test_k4_kernel_matches_plain(cuda, tta, mode, logits_dtype):
    pre, logits, boxes, dets = (torch.from_numpy(a).to(cuda)
                                for a in k4_inputs(128, tta))
    logits = logits.to(logits_dtype)
    kw = dict(tta_w=224 if tta else 0, det_conf=0.5)
    if mode == 'refine':
        kw['refine'] = K4_REFINE
    else:
        kw['dets'] = dets
    out = head_epilogue(pre, logits, boxes, **kw)
    ref = head_epilogue_plain(pre, logits, boxes, **kw)
    if mode == 'refine':
        torch.testing.assert_close(out, ref, rtol=0, atol=1e-4)
    else:
        torch.testing.assert_close(out[:, 6:24], ref[:, 6:24], rtol=0,
                                   atol=1e-6)
        torch.testing.assert_close(out[:, [0, 1, 2, 3, 4, 5, 24, 25]],
                                   ref[:, [0, 1, 2, 3, 4, 5, 24, 25]],
                                   rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize('b,nan_ties', K4_CASES[1:])
@pytest.mark.parametrize('mode', ['refine', 'pack'])
@pytest.mark.parametrize('tta', [False, True])
def test_k4_kernel_crop_counts_nan_ties(cuda, tta, mode, b, nan_ties):
    """B = 1, 127, 129 (a CTA's warps partly live) and logits with NaNs
    and ties across the warp reduction, bf16 as on the serving path."""
    pre, logits, boxes, dets = (torch.from_numpy(a).to(cuda)
                                for a in k4_inputs(b, tta, 4, nan_ties))
    logits = logits.bfloat16()
    kw = dict(tta_w=224 if tta else 0)
    kw.update(dict(refine=K4_REFINE) if mode == 'refine'
              else dict(dets=dets, det_conf=0.5))
    compare_k4(head_epilogue(pre, logits, boxes, **kw),
               head_epilogue_plain(pre, logits, boxes, **kw),
               f'K4 B={b} nan_ties={nan_ties}', mode == 'refine')


@pytest.mark.cuda
@pytest.mark.parametrize('p', [8, 128, 1, 129])
def test_k5_kernel_matches_plain(cuda, p):
    a, b = (torch.from_numpy(x).to(cuda) for x in k5_fuzz_pairs(p, seed=p))
    out = iou_oriented_boxes(a, b)
    torch.testing.assert_close(out, iou_oriented_boxes_plain(a, b), rtol=0,
                               atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize('case', [c[0] for c in k5_exact_cases()])
def test_k5_kernel_exact_cases(cuda, case):
    _, b1, b2, want = next(c for c in k5_exact_cases() if c[0] == case)
    a = torch.tensor(b1, dtype=torch.float32, device=cuda)
    b = torch.tensor(b2, dtype=torch.float32, device=cuda)
    assert abs(float(iou_oriented_boxes(a, b)) - want) < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('case', [c[0] for c in K6_CASES])
def test_k6_kernel_matches_plain(cuda, case, dtype):
    for channels_last in (True, False):
        x, k, stride, pad = k6_input(case, dtype, cuda, channels_last)
        assert k6_plan(qops, x, k, stride, pad).route == \
            k6_route(case, dtype, channels_last)
        for s_x in (127.0, 3.7):
            out = qops.quantize_input(x, s_x, k, stride, pad)
            assert torch.equal(out, qops.quantize_input_plain(x, s_x, k,
                                                              stride, pad))


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('case', [c[0] for c in K7_CASES])
def test_k7_kernel_matches_plain(cuda, case, dtype):
    y, scale, bias = k7_input(case, cuda)
    out = qops.rescale(y, scale, bias, dtype)
    assert out.is_contiguous() and out.dtype == dtype
    assert torch.equal(out, qops.rescale_plain(y, scale, bias, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize('m,k,n', [(17, 32, 320), (49, 1152, 320),
                                   (6272, 160, 960), (200704, 32, 80)])
def test_int_mm_is_exact(cuda, m, k, n):
    """torch._int_mm on the int8 conv's operands ([M,Kp] rows, the [Np,Kp]
    weight transposed) against float64, which holds every such sum."""
    gen = torch.Generator(device=cuda).manual_seed(m)
    a = torch.randint(-127, 128, (m, k), generator=gen, device=cuda,
                      dtype=torch.int8)
    w = torch.randint(-127, 128, (n, k), generator=gen, device=cuda,
                      dtype=torch.int8)
    assert torch.equal(torch._int_mm(a, w.t()).long(),
                       (a.double() @ w.double().t()).long())


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_int8_conv_kernels_match_plain(cuda, dtype):
    """A stem 3×3 stride 2 and a 1×1 conv with a bias through K6, _int_mm
    and K7 against the same conv through the plain K6 and K7; M ≤ 16
    raises."""
    gen = torch.Generator().manual_seed(3)
    for conv, shape in ((torch.nn.Conv2d(3, 16, 3, 2, 1, bias=False),
                         (4, 3, 65, 65)),
                        (torch.nn.Conv2d(24, 40, 1), (2, 24, 9, 9))):
        conv = conv.to(cuda)
        x = (torch.randn(shape, generator=gen) * 3).to(cuda, dtype) \
            .contiguous(memory_format=torch.channels_last)
        out = qops.int8_conv(x, conv, 5.0)
        with plain_quant(qops):
            ref = qops.int8_conv(x, conv, 5.0)
        assert out.dtype == dtype and torch.equal(out, ref)
    with pytest.raises(ValueError, match='16'):
        qops.int8_conv(torch.zeros((1, 24, 4, 4), device=cuda), conv, 1.0)
