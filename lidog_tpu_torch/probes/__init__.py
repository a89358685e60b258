"""The gather and DMA probes of lidog_tpu's benchmarks on the card.

    python -m lidog_tpu_torch.probes {gather,bisect,lanegather,all} [--device cpu]

  gather      micro_gather.main: device-memory row gathers by row width
              (Q1, plain torch indexing), window gathers on LE and LF (Q2,
              P1), P2's 27-tap conv on LA (Q3)
              (benchmarks/micro/micro_gather.py)
  bisect      micro_bisect.main: the windowed async copy on LG (t1) and
              the five window-gather cases on LE and LF (t2-t4b), P4
              (benchmarks/micro/micro_bisect.py)
  lanegather  micro_lanegather.main: the chunked lane gather on LH, P5
              (benchmarks/micro_lanegather.py)

Each runs on the card unless asked for the CPU (where the kernel
wrappers run their plain versions), prints its lines (the device's name
and power limit first) and returns its numbers with a `checks` dict of
named booleans: every one must be true.
"""

PROBES = ("gather", "bisect", "lanegather")
