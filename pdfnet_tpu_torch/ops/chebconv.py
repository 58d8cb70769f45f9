"""Chebyshev basis of a vertex-feature tensor (port of
``pdfnet_tpu/ops/chebconv.py``; reference graph_conv_cheby, gcn.py:34-69).

Basis terms are stacked as (..., F, K) flattened with K fastest, identical to
the reference's view(B*V, Fin*K), so converted weights load unchanged.
"""

from __future__ import annotations

import torch


def cheb_basis(x: torch.Tensor, L: torch.Tensor, K: int) -> torch.Tensor:
    """x: (B, V, F), L: (V, V) dense rescaled Laplacian -> (B, V, F*K)."""
    terms = [x]
    if K > 1:
        x1 = torch.einsum("vw,bwf->bvf", L, x)
        terms.append(x1)
        x0 = x
        for _ in range(2, K):
            x2 = 2.0 * torch.einsum("vw,bwf->bvf", L, x1) - x0
            terms.append(x2)
            x0, x1 = x1, x2
    B, V, F = x.shape
    return torch.stack(terms, dim=-1).reshape(B, V, F * K)
