"""Transform composition (counterpart of ``Chain`` in gpflowpilco_tpu/moments.py).

Only the concrete evaluation is ported; Gaussian moment containers and
``Chain.moment_match`` arrive with moment-matching PILCO.
"""
from __future__ import annotations


class Chain(tuple):
    """Composite transform applying ops right-to-left: Chain(f, g)(x) = f(g(x))."""

    def __new__(cls, *ops):
        return super().__new__(cls, ops)

    def __call__(self, x):
        for op in reversed(self):
            x = op(x)
        return x
