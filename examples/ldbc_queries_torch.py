"""LDBC-SNB-style end-to-end queries (paper §6.5) on the PyTorch port:
IS-3, IC-8, BI-2.

Runs both engines (GraphAr on the port's kernels vs Acero-like join plans
on the host), checks result equivalence, and reports wall + modeled-ESSD
time.  Each timed line says where each side ran; its ``cpu`` column is
the wall-clock speedup of GraphAr over Acero.

Run:  PYTHONPATH=src python examples/ldbc_queries_torch.py [--device cpu]
"""
import argparse
import time

import numpy as np

from _torch_example import add_device_arg, open_device
from repro_torch.core import IOMeter
from repro_torch.core.query import (bi2_acero, bi2_graphar,
                                    build_snb_baseline, build_snb_graphar,
                                    ic8_acero, ic8_graphar, is3_acero,
                                    is3_graphar)
from repro_torch.core.storage import ESSD
from repro_torch.data.synthetic import ldbc_like


def timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def main():
    ap = argparse.ArgumentParser()
    add_device_arg(ap)
    engine, _, where = open_device(ap.parse_args().device)
    label = f"  [graphar on {where}, acero on the host]"

    print("generating LDBC-like graph (scale 2)...")
    snb = ldbc_like(scale=2, seed=0)
    g = build_snb_graphar(snb)
    base = build_snb_baseline(snb)
    deg = np.bincount(snb.knows_src, minlength=snb.num_persons)
    person = int(np.argmax(deg))

    def essd(fn):
        m = IOMeter()
        fn(m)
        return m.seconds(ESSD)

    # a first call of each query outside the timing: the kernels' build
    # and the device mirrors are set-up, as the reference's jit is
    is3_graphar(g, person, engine=engine)
    ic8_graphar(g, person, engine=engine)
    bi2_graphar(g, "TagClass1", engine=engine)

    print(f"\nIS-3: friends of person {person}, newest friendships first")
    (f1, d1), t_g = timed(lambda: is3_graphar(g, person, engine=engine))
    (f2, d2), t_a = timed(lambda: is3_acero(base, person))
    assert set(f1) == set(f2)
    eg = t_g + essd(lambda m: is3_graphar(g, person, m, engine=engine))
    ea = t_a + essd(lambda m: is3_acero(base, person, m))
    print(f"  graphar {t_g*1e3:7.2f} ms | acero {t_a*1e3:7.2f} ms | "
          f"{len(f1)} friends | cpu {t_a/t_g:.1f}x | essd {ea/eg:.1f}x"
          + label)

    print(f"\nIC-8: latest replies to person {person}'s messages")
    (r1, _), t_g = timed(lambda: ic8_graphar(g, person, engine=engine))
    (r2, _), t_a = timed(lambda: ic8_acero(base, person))
    np.testing.assert_array_equal(r1, r2)
    eg = t_g + essd(lambda m: ic8_graphar(g, person, meter=m, engine=engine))
    ea = t_a + essd(lambda m: ic8_acero(base, person, meter=m))
    print(f"  graphar {t_g*1e3:7.2f} ms | acero {t_a*1e3:7.2f} ms | "
          f"{len(r1)} replies | cpu {t_a/t_g:.1f}x | essd {ea/eg:.1f}x"
          + label)

    print("\nBI-2: message counts per tag in TagClass1 (label filtering)")
    c1, t_g = timed(lambda: bi2_graphar(g, "TagClass1", engine=engine))
    c2, t_a = timed(lambda: bi2_acero(base, "TagClass1"))
    assert c1 == c2
    m_g, m_a = IOMeter(), IOMeter()
    bi2_graphar(g, "TagClass1", m_g, engine=engine)
    bi2_acero(base, "TagClass1", m_a)
    print(f"  graphar {t_g*1e3:7.2f} ms | acero {t_a*1e3:7.2f} ms | "
          f"{len(c1)} tags | cpu speedup {t_a/t_g:.1f}x | "
          f"modeled ESSD speedup "
          f"{(t_a+m_a.seconds(ESSD))/(t_g+m_g.seconds(ESSD)):.1f}x" + label)


if __name__ == "__main__":
    main()
