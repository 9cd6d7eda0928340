"""The grouped matmul's backward (``repro_torch.kernels.grouped_matmul.
grouped_matmul_backward``): dX = dY W^T and dW = X^T dY, each where asked
for.  Operations: 2 E cap d f a product (``kernels/meta.py``).  Bytes: dY
read once; w read and dx written where dX runs, x read and dw written where
dW runs."""
from __future__ import annotations

from perfbench.lib import peaks


def count(x, w, dy, needs=(True, True)):
    e, cap, d = x.shape
    f = w.shape[2]
    es = x.element_size()
    need_x, need_w = bool(needs[0]), bool(needs[1])
    products = need_x + need_w
    # dY read; dX needs w read and dx written, dW x read and dw written
    byts = e * cap * f + need_x * (e * d * f + e * cap * d) + need_w * (e * cap * d + e * d * f)
    return products * 2.0 * e * cap * d * f, float(byts * es), peaks.for_dtype(x.dtype)
