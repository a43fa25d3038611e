"""The JAX package's own int8-vs-fp32 gap on ``golden/golden.c2df``.

Its int8 decode of the golden stream (``CodecRuntime(quant="int8")``)
against its fp32 decode, in [-1, 1] pixel units, on the CPU, as
``tests/test_torch_quant.py`` measures it (that test fails if these values
no longer hold).  The card's checks of the port's int8 mode, which have no
JAX, bound the port's int8-vs-fp32 pixels by ``GAP_MULTIPLE`` times these:
the port's int8 mode may stray no more than twice as far from fp32 as the
JAX package's does.
"""
JAX_GAP_MAX = 0.15999067
JAX_GAP_MEAN = 0.015000752
GAP_MULTIPLE = 2.0
