"""Device programs: the vectorized scoring backend.

`constraints.py` compiles constraints/affinities/spreads into boolean
or float lookup tables over interned column vocabularies (numpy only).
`score.py` is one select (kernel K1, `csrc/score_select.cu`) and
`batch.py` the look-ahead scan of P picks (kernel K2,
`csrc/plan_picks.cu`); each module keeps the plain-PyTorch twin of its
kernel beside the wrapper.
"""
