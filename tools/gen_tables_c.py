"""Generate native/qb3xs_tables.inc from the Python table generators so the
C++ helper shares a single source of truth with the JAX kernels."""

import os
import sys
import types

import numpy as np

# Load qb3_tpu.tables without running the package __init__: importing the
# package loads JAX and the native helper, whose build runs this script.
_pkg = types.ModuleType("qb3_tpu")
_pkg.__path__ = [os.path.join(os.path.dirname(__file__), "..", "qb3_tpu")]
sys.modules.setdefault("qb3_tpu", _pkg)

from qb3_tpu import tables as T  # noqa: E402


def emit_u16(name, arr):
    vals = ", ".join(str(int(v)) for v in arr)
    return f"static const uint16_t {name}[] = {{{vals}}};\n"


def packed(tbl):
    """(N, 2) (len, val) -> len<<12 | val packed u16."""
    return (tbl[:, 0].astype(np.uint32) << 12) | tbl[:, 1].astype(np.uint32)


def main(out_path):
    parts = ["// generated by tools/gen_tables_c.py — do not edit\n"]
    for u in (3, 4, 5, 6):
        parts.append(emit_u16(f"DSW{u}", packed(T.DSW[u, : 1 << (u + 1)])))
    for r in range(8):
        parts.append(emit_u16(f"DGRP{r}", packed(T.DEC_GROUP[r, : 1 << (r + 2)])))
        parts.append(emit_u16(f"DSGL{r}", packed(T.DEC_SINGLE[r, : 1 << (r + 2)])))
    parts.append(emit_u16("IDXD", packed(T.IDX_DEC[:16])))
    parts.append("static const uint16_t* DSW_T[7] = {0,0,0,DSW3,DSW4,DSW5,DSW6};\n")
    parts.append("static const uint16_t* DGRP_T[8] = {"
                 + ",".join(f"DGRP{r}" for r in range(8)) + "};\n")
    parts.append("static const uint16_t* DSGL_T[8] = {"
                 + ",".join(f"DSGL{r}" for r in range(8)) + "};\n")
    with open(out_path, "w") as f:
        f.write("".join(parts))
    print(f"wrote {out_path}")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else
         os.path.join(os.path.dirname(__file__), "..", "native", "qb3xs_tables.inc"))
