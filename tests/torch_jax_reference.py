"""The JAX package's functions as the port's tests run them: jitted, one
program a call, with XLA's CPU backend at optimization level 0.

The HLO passes are the same; only LLVM's optimization of the emitted code
is skipped, which is most of a compile on the CPU (a tiny FLUX loss and
its gradient: 3.7 s -> 1.3 s) while the reference's values move by about
1e-7 of their scale, far inside every tolerance these tests state.  The
references run once on tiny inputs, so their speed does not matter.
"""

import jax

REFERENCE_COMPILE = {"xla_backend_optimization_level": 0}


def jit_reference(fun, **kwargs):
    """``jax.jit(fun, **kwargs)`` compiled at ``REFERENCE_COMPILE``."""
    return jax.jit(fun, compiler_options=REFERENCE_COMPILE, **kwargs)
