"""How each kind of configuration is built, counted and judged.

A configuration file names its ``kind``; ``kinds/<kind>.py`` gives

- ``flops(cfg)``: the algorithm's operations for one solve;
- ``k1_work(cfg)``: the operations and bytes of K1's share of a solve,
  counted from the algorithm's tasks;
- ``build(cfg, seed, device)``: a :class:`portbench.harness.Problem`, the
  program's lowered pool on stores made from the seeded inputs;
- ``check(cfg, problem, outs)``: each number compared, from the plain
  reference, for the kept outputs;
- ``stand_in(cfg, problem, name)``: the reference's output, computed as
  one of ``CONTROLS`` (one precision below the configuration's) or of
  ``FAULTS`` (a fault planted), to put in the program's place.
"""
