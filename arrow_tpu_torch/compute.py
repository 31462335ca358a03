"""The compute facade (counterpart of arrow_tpu/ops/__init__.py;
arrow/src/compute/mod.rs:3-23): every kernel re-exported flat, with the
reference crate's names `concat_batches` and `interleave_record_batch`.

It is a module of its own, not `ops/__init__.py` as in the reference:
there the flat names `filter`, `take`, `concat`, `sort`, `cast` and
`join` replace the submodules of the same names as attributes of the
package, so importing `join` from the reference's `ops` gives the
function.  Here
`arrow_tpu_torch.ops.<module>` stays the module, and users call
`arrow_tpu_torch.compute.<kernel>`.

Every name of the reference's facade is here.  The TPU-only code that
ROADMAP lists as not ported (the remote-compiler crash fallbacks, the
f64 host-bitcast routes, compact.py's f64/f16 exclusion, the tunnel
plumbing and the x64 switch) is internal to the reference's modules and
exports no facade name.
"""

from .ops.arity import unary, binary  # noqa: F401
from .ops.numeric import (  # noqa: F401
    add, sub, mul, div, rem, neg,
    add_wrapping, sub_wrapping, mul_wrapping, neg_wrapping,
)
from .ops.boolean import (  # noqa: F401
    and_, or_, not_, and_kleene, or_kleene, is_null, is_not_null,
)
from .ops.cmp import (  # noqa: F401
    eq, neq, lt, lt_eq, gt, gt_eq, distinct, not_distinct,
)
from .ops.take import take, take_table  # noqa: F401
from .ops.filter import (  # noqa: F401
    FilterPredicate, filter, filter_table, filter_static,
)
from .ops.concat import (  # noqa: F401
    concat, concat_tables, interleave, interleave_tables,
)
# the reference crate's names (concat.rs:470, interleave.rs:359)
concat_batches = concat_tables
interleave_record_batch = interleave_tables
from .ops.select_misc import (  # noqa: F401,E402
    zip_, nullif, shift, union_extract,
)
from .ops.ree import run_end_encode, run_end_decode  # noqa: F401,E402
from .ops.ord import (  # noqa: F401,E402
    make_comparator, make_lexicographic_comparator,
)
from .ops.row_format import (  # noqa: F401,E402
    SortOptions, SortField, RowConverter, Rows,
)
from .ops.sort import (  # noqa: F401,E402
    SortColumn, sort_to_indices, sort, lexsort_to_indices, lexsort,
    sort_table, rank, partition, partition_mask, Partitions,
)
from .ops.aggregate import (  # noqa: F401,E402
    sum_, sum_checked, min_, max_, min_max, count, count_nulls,
    bool_and, bool_or, bit_and, bit_or, bit_xor,
)
from .ops.cast import (  # noqa: F401,E402
    cast, can_cast, CastOptions, base64_encode, base64_decode,
)
from .ops.temporal import (  # noqa: F401,E402
    date_part, year, month, day, hour, minute, second, millisecond,
    microsecond, nanosecond, day_of_week, day_of_year, quarter,
    week, iso_week, iso_year, add_interval, sub_interval,
)
from .ops.bitwise import (  # noqa: F401,E402
    bitwise_and, bitwise_or, bitwise_xor, bitwise_not,
    bitwise_shift_left, bitwise_shift_right,
)
from .ops.coalesce import BatchCoalescer  # noqa: F401,E402
from .ops.groupby import (  # noqa: F401,E402
    group_by, AggSpec, GroupByAccumulator, segment_aggregate,
)
from .ops.join import join, join_indices  # noqa: F401,E402
from .ops.strings import (  # noqa: F401,E402
    dictionary_encode, dictionary_decode,
    like, ilike, nlike, nilike, starts_with, ends_with, contains,
    regexp_is_match, regexp_match, substring, length,
    octet_length, bit_length,
    upper, lower, concat_elements,
)
