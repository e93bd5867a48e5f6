"""Switches of the zoo's training and serving paths, the reference's
``repro.models.flags`` with its defaults.

Each switch is read where the reference reads it, when the function runs,
so a caller (or a test) sets the module attribute and the next call sees
it.

Two of the reference's switches have no counterpart, since they would
change nothing here.  ``UNROLL_SCAN`` / ``scan_unroll`` unroll the
reference's scanned layer stack and SSD chunk recurrence so that XLA's
cost analysis, which visits a loop body once, counts every layer; the
port's stacks (``transformer.run_stack``, ``run_stack_decode``) and its
chunk recurrence are Python loops, so the dry run's dispatch-level count
(``repro_torch.launch.dryrun``) already sees every layer.
``DECODE_CACHE_CARRY`` threads the reference's decode cache through its
layer scan as a carry; the port's decode writes each layer's cache slice
in place.
"""

# Blockwise (flash-style) attention: an online softmax over KV blocks of
# this size; the [Sq, Skv] logits never exist whole.  None = materialized
# logits.  Applies to full-sequence self-attention longer than a block.
BLOCKWISE_ATTN: int | None = None

# Mixed-precision gradients: the loss is differentiated against bf16 copies
# of the f32 parameters of more than one dimension; AdamW updates the f32
# masters.
BF16_GRADS: bool = False

# Chunked cross-entropy: the logits are made and consumed in sequence
# chunks of this many tokens, each recomputed in the backward, instead of
# one [B, S, V] f32 tensor.  None = one tensor.
CHUNKED_LOSS: int | None = None

# Serving MoE capacity factor for decode: None = capacity T (no decoded
# token dropped); a float sizes the expert buffers at that factor.
SERVE_MOE_CAP: float | None = None

# bf16 attention softmax: logits, mask, exp and the weighted values stay
# bf16 (row max subtracted); the 1/sqrt(hd) scale is folded into Q.
ATTN_BF16_SOFTMAX: bool = False

# Rotary embedding arithmetic in bf16 (the angle tables in f32).
ROPE_BF16: bool = False

# Sequence parallelism: the residual stream's sequence dim takes the
# logical axis 'seqtp' (``train.sharding.seq_axis``).
SEQ_PARALLEL: bool = False

# Remat of the layer stack under autograd: 'full' recomputes each layer in
# the backward; 'dots' saves the outputs of the weight projections (the
# products with no batch dims) and recomputes the rest.  The port also
# takes None: no remat (every activation kept; small configs only).
REMAT_POLICY: str | None = "full"

# Grouped MoE dispatch: tokens are slotted within G groups with a
# capacity per group.  -1 = one group per batch shard of the active mesh
# (1 off a mesh); 0 = off; > 0 = G groups.
MOE_GROUPED_DISPATCH: int = -1

# KV-cache sharding fallback: where the KV heads do not divide the model
# axis, shard the cache's sequence dim over it instead of replicating.
KV_SHARD_SEQ: bool = True

# SSD (hymba): keep the [B, c, Q, Q, H] intra-chunk decay and score tensors
# in bf16 (the products still accumulate in f32).
SSD_BF16: bool = False

# Cluster cell of the dry run: the dataset and its chunks in bf16 (f32
# accumulation).
CLUSTER_BF16: bool = False
