"""The language-model zoo's serving path, the reference's
``repro.models``: configs (:mod:`config`, :mod:`registry`), layers, the
Mamba2 mixer (:mod:`ssm`), the MoE FFN (:mod:`moe`), the decoder stack
(:mod:`transformer`) and the encoder-decoder (:mod:`encdec`), each with
its ``forward``, ``prefill`` and ``decode_step``; :mod:`decode_check`
holds a decode to the forward.  Training (``loss_fn``) is not part of this
package yet.
"""
