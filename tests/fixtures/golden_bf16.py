"""The JAX package's own bf16-vs-fp32 gap on ``golden/golden.c2df``.

Its bf16 decode of the golden stream (``CodecRuntime(dtype=bf16)``) against
its fp32 decode, in [-1, 1] pixel units, on the CPU, as
``tests/test_torch_bf16.py`` measures it (that test fails if these values
no longer hold).  The card's checks of the port's bf16 mode, which have no
JAX, bound the port's bf16-vs-fp32 pixels by ``GAP_MULTIPLE`` times these:
the port's bf16 mode may round no more than twice as far from fp32 as the
JAX package's does.
"""
JAX_GAP_MAX = 0.14499533
JAX_GAP_MEAN = 0.016192306
GAP_MULTIPLE = 2.0
