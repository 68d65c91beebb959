"""Post-training int8 quantization for serving (counterpart of
``tpudet3d/infer/quant.py``).

* :func:`calibrate` runs a model over batches and records the absmax (or
  the 99.9th percentile) of every dense conv's input, keyed by the conv's
  Flax path: the port names its modules like the Flax tree, so the key is
  the module's name with ``/`` for ``.`` and a scales dict from either
  package serves the other.
* :func:`intercepting` serves the dense ``ConvBN`` convs that have a scale
  through the int8 path (``ops/quant.py`` ``int8_conv``: K6, ``torch._int_mm``,
  K7).  These are exactly the convs the JAX interceptor quantizes: it
  falls through unless the conv's padding is an explicit list, which only
  ``ConvBN`` passes, so the SSD heads' 1×1 convs stay in the model's dtype
  though :func:`calibrate` records them, as do depthwise convs and convs
  without a scale.  ``{}`` or ``None`` changes nothing.

Both work through the hook of ``models/layers.py`` ``conv``, the call site
of every conv of the port's models (they do not run ``nn.Conv2d.forward``).
"""

import warnings
import weakref
from contextlib import contextmanager
from typing import Dict, Iterable, Optional

import numpy as np
import torch
from torch import nn

from ..models import layers
from ..models.layers import ConvBN
from ..ops.quant import int8_conv, int8_weight

__all__ = ['calibrate', 'intercepting', 'quantized_apply', 'calibrate_engine',
           'serve_int8', 'dense_conv_paths', 'quantized_conv_paths',
           'int8_weights', 'int8_versions']

_QUANTIZED = weakref.WeakKeyDictionary()     # model -> {conv: path}


def _key(name):
    return name.replace('.', '/')


def dense_conv_paths(model) -> Dict[nn.Conv2d, str]:
    """``{conv: path}`` of every dense (groups 1) conv of ``model``: the
    convs that the JAX ``calibrate`` records."""
    return {m: _key(name) for name, m in model.named_modules()
            if isinstance(m, nn.Conv2d) and m.groups == 1}


def quantized_conv_paths(model) -> Dict[nn.Conv2d, str]:
    """``{conv: path}`` of the convs that the JAX interceptor quantizes when
    they have a scale: the dense convs of ``ConvBN`` (found once per
    model)."""
    convs = _QUANTIZED.get(model)
    if convs is None:
        convs = {m.Conv_0: _key(f'{name}.Conv_0' if name else 'Conv_0')
                 for name, m in model.named_modules()
                 if isinstance(m, ConvBN) and m.Conv_0.groups == 1}
        _QUANTIZED[model] = convs
    return convs


@contextmanager
def _conv_hook(fn):
    """Install ``fn(x, layer)`` as this thread's conv hook while inside."""
    prev = getattr(layers.conv_hook, 'fn', None)
    layers.conv_hook.fn = fn
    try:
        yield
    finally:
        layers.conv_hook.fn = prev
        layers.conv_hook.cast = None


def calibrate(model, batches: Iterable, method: str = 'absmax',
              **forward_kwargs) -> Dict[str, float]:
    """Run ``model`` over ``batches`` (tuples of forward arguments) and
    return ``{conv_path: input statistic}`` over every dense conv, the
    largest over the batches; the stem conv's input is the model's input
    before its dtype cast (``models/layers.py`` ``model_input``), as JAX
    records it.  ``'absmax'`` keeps a running max of ``|x|``
    on the device with one host read per batch; ``'p999'`` takes
    ``np.percentile(|x|, 99.9)`` of each input on the host."""
    paths = dense_conv_paths(model)
    stats: Dict[str, float] = {}
    if method == 'p999':
        def record(x, layer):
            path = paths.get(layer)
            if path is not None:
                v = float(np.percentile(np.abs(
                    layers.uncast(x).detach().float().cpu().numpy()), 99.9))
                stats[path] = max(stats.get(path, 0.0), v)

        with torch.no_grad(), _conv_hook(record):
            for batch in batches:
                model(*batch, **forward_kwargs)
        return stats
    if method != 'absmax':
        raise ValueError(f"method must be 'absmax' or 'p999', not {method!r}")

    running = {}

    def record(x, layer):
        path = paths.get(layer)
        if path is not None:
            m = layers.uncast(x).detach().float().abs().amax()
            running[path] = (m if path not in running
                             else torch.maximum(running[path], m))

    with torch.no_grad(), _conv_hook(record):
        for batch in batches:
            running.clear()
            model(*batch, **forward_kwargs)
            if running:
                values = torch.stack(list(running.values())).tolist()
                for k, v in zip(running, values):
                    stats[k] = max(stats.get(k, 0.0), v)
    return stats


def _scaled_convs(model, act_scales) -> Dict[nn.Conv2d, float]:
    """``{conv: scale}`` of the convs that :func:`intercepting` serves
    int8: the quantizable ones with a non-zero scale."""
    return {m: float(act_scales[path])
            for m, path in quantized_conv_paths(model).items()
            if act_scales.get(path)}


def int8_weights(model, act_scales):
    """The int8 weights and rescales (``ops/quant.py`` ``int8_weight``)
    that ``model``'s forward under ``intercepting(model, act_scales)``
    reads.  A CUDA graph captured there reads them where they lay at its
    capture, so it holds them: a later calibration that makes new ones
    cannot free them under it."""
    return [int8_weight(conv, s_x) for conv, s_x in
            _scaled_convs(model, act_scales or {}).items()]


def int8_versions(model, act_scales) -> tuple:
    """The versions of the weights that :func:`int8_weights` quantizes: a
    weight loaded in place (``load_state_dict``) has a new one, so a CUDA
    graph keyed on them is captured again with new int8 copies."""
    if not act_scales:
        return ()
    return tuple(conv.weight._version for conv, path in
                 quantized_conv_paths(model).items() if act_scales.get(path))


@contextmanager
def intercepting(model, act_scales: Optional[Dict[str, float]]):
    """``with intercepting(model, scales): model(...)`` serves ``model``'s
    quantizable convs with a non-zero scale through the int8 path; every
    other conv, and any conv when ``scales`` is empty or None, runs as it
    does without the context."""
    if not act_scales:
        yield
        return
    convs = _scaled_convs(model, act_scales)

    def quantized(x, layer):
        s_x = convs.get(layer)
        return None if s_x is None else int8_conv(x, layer, s_x)

    with _conv_hook(quantized):
        yield


def quantized_apply(model, *args, act_scales: Dict[str, float], **kwargs):
    """One forward of ``model`` under :func:`intercepting`."""
    with torch.no_grad(), intercepting(model, act_scales):
        return model(*args, **kwargs)


def calibrate_engine(engine, frames, method: str = 'absmax', dets=None):
    """Calibrate both stages of a ``TwoStageEngine`` on representative
    frames; returns ``(det_scales, reg_scales)`` for
    ``EngineConfig.det_int8_scales`` / ``reg_int8_scales``.

    Reproduces the stages' inputs as the JAX ``calibrate_engine`` does:
    the detector on the frames resized to 300² in float32 and divided by
    255; the regressor on the crops of each frame's K3 detections above
    ``det_conf`` (scaled to the frame, widened by ``crop_margin_px`` and
    clipped to it), cropped in float32 and normalised as ``(x - mean·255) /
    (std·255)`` (not the engine's bfloat16 scale and offset).  ``frames``
    is an ``[N,H,W,3]`` uint8 array or a list of HWC uint8 frames of any
    shapes.  ``dets`` (one ``[K,6]`` array a frame, detector pixels, as
    K3 gives them) replaces the detector's own detections as the crops'
    source.  Without a detection above ``det_conf`` it warns and returns
    the detector's scales with ``{}`` for the regressor, which then serves
    unquantized."""
    from ..detect.anchors import INPUT_SIZE
    from ..detect.nms import decode_detections
    from ..ops.image import crop_and_resize, resize_bilinear
    from .engine import REG_MEAN, REG_STD, upload

    cfg, dev = engine.cfg, engine.device
    frames = [upload(np.asarray(f)[None], dev) for f in frames]
    f32 = torch.float32
    det_in = torch.cat([
        resize_bilinear(f, (INPUT_SIZE, INPUT_SIZE),
                        reverse_channels=cfg.input_is_bgr, dtype=f32)
        for f in frames]) / torch.tensor(255.0, device=dev)
    det_scales = calibrate(engine.det_model, [(det_in,)], method=method)

    if dets is None:
        with torch.no_grad():
            logits, deltas = engine.det_model(det_in)
            dets = decode_detections(
                logits.contiguous(), deltas.contiguous(), engine.anchors,
                score_thr=cfg.score_thr, iou_thr=cfg.nms_iou,
                max_per_img=cfg.max_detections,
                pre_nms_k=max(4 * cfg.max_detections, 32),
                soft_nms_sigma=cfg.soft_nms_sigma,
                soft_nms_dup_iou=cfg.soft_nms_dup_iou).cpu().numpy()
    mean = torch.tensor(np.asarray(REG_MEAN, np.float32) * 255.0, device=dev)
    std = torch.tensor(np.asarray(REG_STD, np.float32) * 255.0, device=dev)
    crops = []
    for f, d in zip(frames, dets):
        h, w = f.shape[1:3]
        scale = np.asarray([w / INPUT_SIZE, h / INPUT_SIZE] * 2, np.float32)
        boxes = d[d[:, 4] > cfg.det_conf][:, :4] * scale
        if not len(boxes):
            continue
        m = float(cfg.crop_margin_px)
        boxes = np.clip(boxes + np.asarray([-m, -m, m, m], np.float32), 0,
                        np.asarray([w, h, w, h], np.float32))
        c = crop_and_resize(f, torch.from_numpy(boxes)[None].to(dev),
                            tuple(cfg.crop_size),
                            reverse_channels=cfg.input_is_bgr, dtype=f32)
        crops.append((c - mean) / std)
    if not crops:
        warnings.warn('calibrate_engine: no detections above det_conf on '
                      'the calibration frames; the regressor stays '
                      'unquantized')
        return det_scales, {}
    reg_scales = calibrate(engine.reg_model, [(torch.cat(crops),)],
                           method=method)
    return det_scales, reg_scales


def serve_int8(engine, frames):
    """Calibrate both stages of ``engine`` on ``frames``
    (:func:`calibrate_engine`) and set its config to serve them int8 from
    its next call, as the JAX CLIs do; returns ``(det_scales,
    reg_scales)``."""
    det_scales, reg_scales = calibrate_engine(engine, frames)
    engine.cfg.det_int8_scales = det_scales
    engine.cfg.reg_int8_scales = reg_scales
    return det_scales, reg_scales
