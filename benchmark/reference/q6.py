"""TPC-H Q6: revenue of a year's lineitem within a discount band and
under a quantity."""

from __future__ import annotations

from .common import cents, day_range, exact, money


def answer(tables, params, money_dtype=None):
    li = tables["lineitem"]
    d = cents(li["l_discount"])
    sel = day_range(li["l_shipdate"], params["DATE"], params["DATE_END"]) \
        & (d >= params["DISCOUNT_LO_CENTS"]) \
        & (d <= params["DISCOUNT_HI_CENTS"]) \
        & (cents(li["l_quantity"]) < 100 * params["QUANTITY"])
    if money_dtype is None:
        p = cents(li["l_extendedprice"])
        revenue = exact(int((p * d)[sel].sum()), 10 ** 4)
    else:
        revenue = float((money(li["l_extendedprice"], money_dtype)
                         * money(li["l_discount"], money_dtype))[sel].sum())
    return [{"revenue": revenue}], 1
