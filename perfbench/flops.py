"""Model FLOPs of one train step, counted from a configuration's shapes:
forward and backward of every conv, transposed conv and dense layer, two
flops a multiply-add. The backward is twice the forward (input and weight
gradients), less the input gradient of the first conv, whose input is the
image. A net run without gradient (CM-UNet's target) counts its forward
only. Nothing recomputed and no element-wise work is counted, and a masked
encoder counts its dense work, which the program computes.
"""

from __future__ import annotations

def conv(h: int, w: int, cin: int, cout: int, k: int) -> float:
    return 2.0 * k * k * cin * cout * h * w


def encoder(size: int, widths, bottleneck: int):
    """(forward flops, forward flops of the first conv) of the encoder on
    one (size, size) image."""
    total, cin, h = 0.0, 1, size
    for w in list(widths) + [bottleneck]:
        total += conv(h, h, cin, w, 3) + conv(h, h, w, w, 3)
        cin, h = w, h // 2
    return total, conv(size, size, 1, widths[0], 3)


def decoder(size: int, out: int, widths, bottleneck: int) -> float:
    """Forward flops of the decoder (transposed convs, DoubleConvs, head)
    on one image whose full resolution is (size, size)."""
    total, cin = 0.0, bottleneck
    for lvl in range(len(widths), 0, -1):
        w = widths[lvl - 1]
        h = size >> (lvl - 1)
        total += conv(h // 2, h // 2, cin, w, 2)  # 2x2 stride 2: per input
        total += conv(h, h, 2 * w, w, 3) + conv(h, h, w, w, 3)
        cin = w
    return total + conv(size, size, widths[0], out, 1)


def dense(cin: int, cout: int) -> float:
    return 2.0 * cin * cout


def trained(forward: float, first_conv: float) -> float:
    """Forward, input and weight gradients; the image needs no gradient."""
    return 3.0 * forward - first_conv


def step_flops(cfg: dict, batch: int) -> float:
    """Model FLOPs of one step of `batch` images: the configuration's
    reference counts an image (`image_flops`)."""
    from perfbench.cells import reference_module

    return batch * reference_module(cfg["task"]).image_flops(cfg)
