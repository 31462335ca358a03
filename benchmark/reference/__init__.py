"""The plain reference: each query of queries/ recomputed in plain PyTorch
from the generator's tensors (tpch_gen.Col), one module a query, found by
the query's name (`reference/<name lowercased>.py`, function `answer`).

`answer(tables, params, money_dtype=None)` gives the query's answer and
the number of rows it must have.  With `money_dtype=None` the arithmetic
is exact: the Float64 money columns are read back as integer cents (they
are the cents over 100), sums are taken in int64 and floats come out as
fractions.Fraction.  With a torch float dtype, the money columns are cast
to it and every product and sum is taken in it: the lower-precision
control.  Row selection is the same in both.  Nothing here imports the
program or JAX.
"""
