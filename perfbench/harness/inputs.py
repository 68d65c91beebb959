"""The inputs of every cell, made on the card from ``--seed`` with a
``torch.Generator``; the same seed gives the same inputs, and every seed
the same sizes.

Frames and training images are blocky scenes: a background of random
colour cells, pixel noise, and a few filled rectangles (objects for the
detector's anchors to find), uint8 BGR.
"""

import torch

# independent streams of one run, each from (seed, stream)
STREAMS = {'weights_det': 1, 'weights_reg': 2, 'frames': 3, 'train': 4,
           'augment': 5, 'sample': 6}


def stream_seed(seed, name):
    """A 63-bit seed for stream ``name`` of run ``seed``."""
    return (int(seed) * 1000003 + STREAMS[name] * 7919) % (2 ** 63)


def scenes(n, h, w, cell, gen, device, rects=(3, 6)):
    """``[n,h,w,3]`` uint8: ``cell``-pixel colour blocks, ±12 noise and
    ``rects[0]``–``rects[1]-1`` rectangles of 1/8 to 1/2 of each side."""
    ch, cw = -(-h // cell), -(-w // cell)
    cells = torch.randint(0, 256, (n, ch, cw, 3), generator=gen,
                          device=device, dtype=torch.int16)
    img = cells.repeat_interleave(cell, 1).repeat_interleave(cell, 2)
    img = img[:, :h, :w] + torch.randint(-12, 13, (n, h, w, 3), generator=gen,
                                         device=device, dtype=torch.int16)
    k = rects[1] - 1
    count = torch.randint(rects[0], rects[1], (n,), generator=gen,
                          device=device)
    u = torch.rand((n, k, 4), generator=gen, device=device)
    fill = torch.randint(0, 256, (n, k, 3), generator=gen, device=device,
                         dtype=torch.int16)
    bh = (h // 8 + u[..., 0] * (h // 2 - h // 8)).long()
    bw = (w // 8 + u[..., 1] * (w // 2 - w // 8)).long()
    y0 = (u[..., 2] * (h - bh)).long()
    x0 = (u[..., 3] * (w - bw)).long()
    ys = torch.arange(h, device=device).view(1, h, 1)
    xs = torch.arange(w, device=device).view(1, 1, w)
    for j in range(k):
        def span(v, lo, side):
            return (v >= lo[:, j, None, None]) \
                & (v < (lo + side)[:, j, None, None])
        inside = (span(ys, y0, bh) & span(xs, x0, bw)
                  & (j < count).view(n, 1, 1))
        img = torch.where(inside[..., None], fill[:, j, None, None, :], img)
    return img.clamp(0, 255).to(torch.uint8)


def frame_pool(seed, pool, batch, h, w, device):
    """``pool`` batches of ``batch`` 720p-style frames, on the host."""
    gen = torch.Generator(device=device).manual_seed(
        stream_seed(seed, 'frames'))
    return [scenes(batch, h, w, 16, gen, device).cpu().numpy()
            for _ in range(pool)]


def train_pool(seed, pool, batch, size, classes, device):
    """``pool`` training batches on the card: uint8 images ``[B,s,s,3]``,
    keypoints in pixels ``[B,9,2]`` (inside the image) and labels ``[B]``
    in ``[0, classes)``."""
    gen = torch.Generator(device=device).manual_seed(
        stream_seed(seed, 'train'))
    out = []
    for _ in range(pool):
        imgs = scenes(batch, size, size, 8, gen, device)
        kps = torch.rand((batch, 9, 2), generator=gen, device=device) \
            * (size - 1)
        cats = torch.randint(0, classes, (batch,), generator=gen,
                             device=device)
        out.append((imgs, kps, cats))
    return out
