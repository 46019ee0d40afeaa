"""The LM unembedding widened to f32, for checks that compare two runs on
f32 hidden states (the port on two devices, or the port and the JAX
package).

The shipped unembedding rounds its operands to bf16, so an f32 difference
of 1e-7 in a hidden state can flip a rounding and move the logits it feeds
by a whole bf16 step of that input (2^-8 relative). A check swaps in
``unembed_f32`` on both sides of its comparison and holds the shipped one
alone, on identical inputs. Imports torch and the port only, so that the
card tests and ``chip_smoke.py`` use it too.
"""
import contextlib

import repro_torch.models.layers as tlayers


def unembed_f32(params, x):
    t = params["table"]
    return (x.float().reshape(-1, x.shape[-1]) @ t.float().t()).reshape(
        x.shape[:-1] + (t.shape[0],))


@contextlib.contextmanager
def f32_unembed(*more):
    """The port's ``layers.unembed`` is ``unembed_f32`` while inside, and
    for each ``(module, fn)`` of ``more``, ``module.unembed`` is ``fn``."""
    swaps = [(tlayers, unembed_f32), *more]
    saved = [module.unembed for module, _ in swaps]
    for module, fn in swaps:
        module.unembed = fn
    try:
        yield
    finally:
        for (module, _), fn in zip(swaps, saved):
            module.unembed = fn
