"""LIBSVM text-format loader (reference experiments/libsvm.jl:3-61).

Parses ``label idx:val idx:val ...`` lines into a dense (row-major, zero
padded) feature matrix + label vector. The reference builds a Julia
SparseMatrixCSC; here the hot matvec wants a dense device-resident matrix,
so densification happens here (the reference
datasets are small: a5a is 6414 x 123). Binary label remapping with
validation mirrors libsvm.jl:41-58.
"""

from __future__ import annotations

import numpy as np

__all__ = ["load_libsvm_dataset", "round_up"]


def round_up(x: int, multiple: int) -> int:
    return -(-x // multiple) * multiple


def load_libsvm_dataset(
    file_path,
    dtype=np.float64,
    labels=None,
    *,
    pad_to: int | None = None,
    n_features: int | None = None,
    engine: str = "auto",
):
    """Returns ``(X, y)`` as numpy arrays. ``labels=(l0, l1)`` remaps a binary
    label set to ``(l0, l1)`` by value order, erroring if not binary.
    ``pad_to`` zero-pads both dims up to a multiple (block alignment).
    ``engine``: "native" (parallel C++ parser), "python", or "auto" (native
    with python fallback).
    """
    if labels is not None:
        if len(labels) != 2 or labels[0] == labels[1]:
            raise ValueError("labels must be two distinct values")
    if engine not in ("auto", "native", "python"):
        raise ValueError(f"unknown engine {engine!r}")

    parsed = None
    if engine in ("auto", "native"):
        from .. import native

        parsed = native.parse_libsvm_dense(file_path)
        if parsed is None and engine == "native":
            raise RuntimeError(
                f"native libsvm parser unavailable: {native.build_error()}"
            )

    if parsed is not None:
        x64, y64, m, n = parsed
        if n_features is not None:
            n = max(n, n_features)
        if pad_to is not None:
            m_pad, n_pad = round_up(m, pad_to), round_up(n, pad_to)
        else:
            m_pad, n_pad = m, n
        x = np.zeros((m_pad, n_pad), dtype=dtype)
        x[: x64.shape[0], : min(n_pad, x64.shape[1])] = x64[:, : min(n_pad, x64.shape[1])]
        y = y64[:m].astype(dtype)
    else:
        ys = []
        rows, cols, vals = [], [], []
        with open(file_path) as fh:
            for i, line in enumerate(fh):
                tokens = line.strip().split()
                if not tokens:
                    continue
                ys.append(dtype(tokens[0]))
                for tok in tokens[1:]:
                    c, v = tok.split(":")
                    idx = int(c)
                    if idx < 1:
                        # LIBSVM is 1-indexed; idx-1 = -1 would silently
                        # write into the LAST column (the native parser
                        # rejects the same file with err=4)
                        raise ValueError(
                            f"line {i + 1}: feature index {idx} < 1 "
                            "(LIBSVM indices are 1-based)")
                    rows.append(len(ys) - 1)
                    cols.append(idx - 1)
                    vals.append(dtype(v))

        m = len(ys)
        n = (max(cols) + 1) if cols else 0
        if n_features is not None:
            n = max(n, n_features)
        if pad_to is not None:
            m_pad, n_pad = round_up(m, pad_to), round_up(n, pad_to)
        else:
            m_pad, n_pad = m, n
        x = np.zeros((m_pad, n_pad), dtype=dtype)
        # explicit int dtype: empty lists become float64 index arrays,
        # which raise an obscure IndexError for labels-only files
        x[np.asarray(rows, dtype=np.intp),
          np.asarray(cols, dtype=np.intp)] = np.asarray(vals, dtype=dtype)
        y = np.asarray(ys, dtype=dtype)

    if labels is not None:
        uniq = np.unique(y)
        if uniq.size != 2:
            raise ValueError(f"expected binary labels, got {uniq.size} values")
        y0, y1 = uniq.min(), uniq.max()
        l0, l1 = labels
        if not (y0 in labels and y1 in labels):
            out = y.copy()
            out[y == y0] = l0
            out[y == y1] = l1
            y = out

    if pad_to is not None:
        y_pad = np.zeros(m_pad, dtype=dtype)
        y_pad[:m] = y
        return x, y_pad, m, n
    return x, y
