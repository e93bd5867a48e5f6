"""Training of the language-model zoo, the reference's ``repro.train``:
:mod:`optimizer` (AdamW, learning-rate schedules), :mod:`train_step` (the
train, serve and prefill steps) and :mod:`sharding` (the logical-axis
rules, pure functions of a mesh's axis names and shape).
"""
