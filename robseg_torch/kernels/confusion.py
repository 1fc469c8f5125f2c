"""Confusion-matrix histogram: the CUDA kernel and its plain version.

Port of ``robseg_tpu/kernels/confusion.py::confusion_matrix_pallas``; the
kernel is ``robseg_torch/csrc/confusion.cu``.

``hist[t, p]`` counts the pixels with true class ``t`` and prediction ``p``,
over pixels where ``t != ignore_label``, ``0 <= t < K`` and ``0 <= p < K``.
Returns float32 counts, ``(K, K)`` summed over the batch or ``(B, K, K)``
per image. A CPU tensor takes the plain version; a CUDA tensor launches the
kernel, and anything the kernel does not take raises.

The kernel takes any number of classes ``K >= 1``, in one of two forms that
``plan`` chooses: the shared form for ``K <= 238`` (the whole K x K int32
histogram in shared memory, per warp where it fits) and the global form
above that (the histogram in the output in global memory, where the
atomics resolve in the L2, the diagonal in shared memory). Both write
float32 counts directly when every count stays below 2^24 (exact in
float32, as in the JAX kernel's float32 accumulator), and int32 counts,
converted after, above that.
``confusion_matrix_v1_cuda`` launches the shared form's first design, for
``chip_smoke.py``'s comparison only; nothing in the package calls it.
"""

from __future__ import annotations

import functools

import torch

from robseg_torch.kernels import _build


def confusion_matrix_plain(pred, target, *, num_classes: int,
                           ignore_label: int = -1, per_image: bool = False):
    """``torch.bincount`` over ``(image, t, p)`` of the counted pixels."""
    k = num_classes
    b = pred.shape[0]
    p = pred.reshape(b, -1).long()
    t = target.reshape(b, -1).long()
    valid = ((t != ignore_label) & (t >= 0) & (t < k) & (p >= 0) & (p < k))
    img = torch.arange(b, device=p.device).view(b, 1).expand_as(p)
    idx = (img * k + t) * k + p
    hist = torch.bincount(idx[valid], minlength=b * k * k).view(b, k, k)
    if not per_image:
        hist = hist.sum(0)
    return hist.to(torch.float32)


F32_EXACT = 2 ** 24
THREADS = 512           # csrc/confusion.cu: kThreads
WARPS = THREADS // 32
RUN = 8                 # pixels a thread takes at once
SMEM_TWO_BLOCKS = 113 * 1024  # two blocks fit on an SM
# the largest K of the shared form: one K x K int32 copy of 226,576 bytes
SHARED_MAX_CLASSES = 238
FORMS = {"shared": 0, "global": 1}
# the global form per image: where the rows' outputs pass this share of the
# L2 (where the atomics resolve), half the rows are counted at once, so that
# the outputs being counted stay in it. On an NVIDIA H100 80GB HBM3 (50 MiB
# of L2) at 700 W, 16 images of random labels at K = 716 (0.63 of the L2)
# took 0.0886 -> 0.0733 ms of device time, at K = 847 (0.88) 0.1136 ->
# 0.0870 (chip_ab.py --what confusion; PERF.md, row 6b).
L2_ROWS_SHARE = (5, 8)


def plan(k: int, rows: int, n: int, sms: int, l2_bytes: int) -> dict:
    """The kernel's form and launch for ``rows`` histograms (the images
    when per image, else 1) of ``n`` pixels each on a card with ``sms``
    SMs and ``l2_bytes`` of L2. ``width`` is the ints of one shared copy:
    the K x K histogram in the shared form, the diagonal (at most 28,928
    classes, the rest go to global memory) in the global form; ``copies``
    one a warp where they fit in a two-blocks-a-SM budget. The grid is the
    card's resident blocks split over the rows, with no block below one
    8-pixel group a thread; in the global form over half the rows where
    their 4-byte outputs pass ``L2_ROWS_SHARE`` of the L2 (twice the
    blocks a row, so the blocks resident at once count half the rows)."""
    live = rows
    if k <= SHARED_MAX_CLASSES:
        form, width = "shared", k * k
    else:
        form, width = "global", min(k, SMEM_TWO_BLOCKS // 4)
        num, den = L2_ROWS_SHARE
        if 4 * k * k * rows * den > l2_bytes * num:
            live = max(1, rows // 2)
    copies = max(1, min(WARPS, SMEM_TWO_BLOCKS // (4 * width)))
    smem = 4 * copies * width
    per_sm = 2 if smem <= SMEM_TWO_BLOCKS else 1
    need = (n // RUN + THREADS - 1) // THREADS
    grid_x = max(1, min(sms * per_sm // live, need))
    return {"form": form, "width": width, "copies": copies, "smem": smem,
            "blocks_per_sm": per_sm, "grid": (grid_x, rows)}


@functools.lru_cache(maxsize=None)
def card(index: int) -> tuple:
    """(SMs, L2 bytes) of card ``index``: ``plan``'s card arguments."""
    props = torch.cuda.get_device_properties(index)
    return props.multi_processor_count, props.L2_cache_size


def _checked(pred, target, num_classes):
    """pred and target as contiguous, 16-byte aligned (B, P) int64 rows."""
    if num_classes < 1:
        raise ValueError("confusion_matrix: num_classes must be at least 1; "
                         f"got {num_classes}")
    if not pred.is_cuda:
        raise ValueError(f"confusion_matrix_cuda: pred is on {pred.device}, "
                         "not CUDA")
    if pred.shape != target.shape or pred.ndim < 1:
        raise ValueError(f"confusion_matrix: pred {tuple(pred.shape)} and "
                         f"target {tuple(target.shape)} must match")
    for name, t in (("pred", pred), ("target", target)):
        if t.dtype != torch.int64 or t.device != pred.device:
            raise ValueError(f"confusion_matrix: {name} must be int64 on "
                             f"{pred.device}; got {t.dtype} on {t.device}")
    b = pred.shape[0]
    rows = []
    for t in (pred, target):
        t = t.reshape(b, -1).contiguous()
        rows.append(t if t.data_ptr() % 16 == 0 else t.clone())
    return rows


def confusion_matrix_cuda(pred, target, *, num_classes: int,
                          ignore_label: int = -1, per_image: bool = False):
    """Launch the kernel in the form ``plan`` chooses; pred and target int64
    of one shape on one CUDA device, leading dimension the batch."""
    pred, target = _checked(pred, target, num_classes)
    b, n = pred.shape
    k = num_classes
    rows, row_pixels = (b, n) if per_image else (1, b * n)
    launch = plan(k, rows, row_pixels, *card(pred.device.index))
    f32 = b * n < F32_EXACT
    hist = torch.empty((b, k, k) if per_image else (k, k),
                       dtype=torch.float32 if f32 else torch.int32,
                       device=pred.device)
    err = _build.library().robseg_confusion(
        pred.data_ptr(), target.data_ptr(), hist.data_ptr(), b, n, k,
        int(ignore_label), 0 if per_image else 1, int(f32),
        FORMS[launch["form"]], launch["copies"], launch["width"],
        launch["grid"][0], torch.cuda.current_stream(pred.device).cuda_stream)
    _build.check(err, "confusion_matrix")
    confusion_matrix_cuda.launches += 1
    return hist if f32 else hist.to(torch.float32)


confusion_matrix_cuda.launches = 0


def confusion_matrix_v1_cuda(pred, target, *, num_classes: int,
                             ignore_label: int = -1, per_image: bool = False):
    """The shared form's first design (one shared atomic a pixel, one K x K
    copy), int32 counts converted to float32; counts no launches."""
    if num_classes > SHARED_MAX_CLASSES:
        raise ValueError("confusion_matrix_v1: the first design holds one "
                         f"K x K histogram in shared memory, K <= "
                         f"{SHARED_MAX_CLASSES}; got {num_classes}")
    pred, target = _checked(pred, target, num_classes)
    b, n = pred.shape
    k = num_classes
    hist = torch.zeros((b, k, k) if per_image else (k, k),
                       dtype=torch.int32, device=pred.device)
    err = _build.library().robseg_confusion_v1(
        pred.data_ptr(), target.data_ptr(), hist.data_ptr(), b, n, k,
        int(ignore_label), 0 if per_image else 1,
        torch.cuda.current_stream(pred.device).cuda_stream)
    _build.check(err, "confusion_matrix_v1")
    return hist.to(torch.float32)


def confusion_hist(pred, target, *, num_classes: int, ignore_label: int = -1,
                   per_image: bool = False):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    fn = confusion_matrix_cuda if pred.is_cuda else confusion_matrix_plain
    return fn(pred, target, num_classes=num_classes,
              ignore_label=ignore_label, per_image=per_image)
