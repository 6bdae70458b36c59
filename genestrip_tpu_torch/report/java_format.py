"""Java-compatible number formatting for bit-exact CSV parity.

The reference writes doubles via PrintStream.print(double), i.e.
Double.toString: the shortest decimal that uniquely identifies the value,
rendered in plain form for 1e-3 <= |x| < 1e7 and in 'computerized
scientific notation' otherwise (ref: ResultReporter printing paths).
Python's repr() also produces shortest round-trip digits, so we reuse its
digits and re-render them with Java's layout rules.
"""

from __future__ import annotations

import math


def java_double_str(x: float) -> str:
    if x != x:
        return "NaN"
    if x == float("inf"):
        return "Infinity"
    if x == float("-inf"):
        return "-Infinity"
    sign = "-" if (x < 0 or (x == 0 and math.copysign(1, x) < 0)) else ""
    a = abs(x)
    if a == 0.0:
        return sign + "0.0"
    s = repr(a)
    # parse digits + exponent-of-first-digit
    if "e" in s or "E" in s:
        mant, _, e = s.partition("e" if "e" in s else "E")
        e = int(e)
    else:
        mant, e = s, 0
    if "." in mant:
        point = mant.index(".")
        digits = mant[:point] + mant[point + 1:]
    else:
        point = len(mant)
        digits = mant
    # exponent of the first digit in `digits`
    exp = point - 1 + e
    lead = 0
    while lead < len(digits) - 1 and digits[lead] == "0":
        lead += 1
        exp -= 1
    digits = digits[lead:].rstrip("0") or "0"
    if -3 <= exp < 7:
        if exp >= 0:
            int_part = digits[: exp + 1].ljust(exp + 1, "0")
            frac = digits[exp + 1:] or "0"
            return f"{sign}{int_part}.{frac}"
        return sign + "0." + "0" * (-exp - 1) + digits
    frac = digits[1:] or "0"
    return f"{sign}{digits[0]}.{frac}E{exp}"


def java_float_str(x: float) -> str:
    """Float.toString analogue (not currently needed for parity, see above)."""
    return java_double_str(x)


def decimal_format_8(x: float) -> str:
    """DecimalFormat("0.00000000") with US symbols and HALF_EVEN rounding
    (ref: ResultReporter.java:49)."""
    if x != x:
        return "NaN"
    if x == float("inf"):
        return "∞"
    if x == float("-inf"):
        return "-∞"
    return f"{x:.8f}"
