"""The language-model zoo, the reference's ``repro.models``: configs
(:mod:`config`, :mod:`registry`), the switches (:mod:`flags`), layers, the
Mamba2 mixer (:mod:`ssm`), the MoE FFN (:mod:`moe`), the decoder stack
(:mod:`transformer`) and the encoder-decoder (:mod:`encdec`), each with
its differentiable ``forward_body`` and ``loss_fn`` (training:
``repro_torch.train``) and its serving ``forward``, ``prefill`` and
``decode_step``; :mod:`decode_check` holds a decode to the forward.
"""
