"""The PILCO variants the benchmark drives, one module each.

A traffic mix names its variant (``"system": "<name>"``, no default), and
the harness loads ``systems/<name>.py`` by path (``harness/spec.py:
variant_module``). Everything particular to a variant sits in its module,
so a later change adds a variant, its reference, its counts and its traced
kernels as new files, and edits none. A variant module provides:

- ``make_inputs(cfg, seed, dtype, device)`` and ``dims(cfg)``: the inputs
  both sides of the comparison get, and the shapes the readers see
  (``run["dims"]``);
- ``build_system(cfg, traffic, inputs, step_seed, device)``: the
  ``harness/system.py:System`` whose ``loss()`` the window's Adam steps
  call (``harness/system.py``'s ``loop_args`` and ``assemble`` build what
  every variant shares);
- ``SPANS``: ``(owner, attribute, name)`` of each function of the port that
  a traced run times, by wrapping ``owner.attribute``: a host-clock span
  under ``run["spans"][name]`` in the window, a ``record_function`` span
  ``name`` in the profiled slice, which names the idle gaps inside it;
- ``COSTS``: ``(owner, attribute)`` of the function whose return is the
  first step's per-particle costs (the record's ``costs``), or None;
- ``step_ops(dims)``: the operations of one policy step (``step_mfu``);
- ``reference_record(cfg, traffic, inputs, step_seed, *, control=False,
  kept=None, **fault)``: the plain reference's record (``harness/check.py``)
  in float64, or with ``control`` in the traffic's ``control`` dtype, or
  with a fault's keywords;
- ``FAULTS``: ``{name: keywords of reference_record}``, the reference's
  faults that ``readings.py --fault-seeds`` puts in the program's place;
  ``TWIN``: the keywords of the reference from its one-ulp twin
  (``--twin-seeds``), or None;
- ``kept_particles(cfg, traffic, inputs, step_seed, tau)``, ``twin_gaps(cfg,
  traffic, inputs, step_seed)`` and ``kept_gradient(steps, step_seed,
  kept)``: the particles ``grad_gap_kept`` keeps, each particle's gap to
  its twin, and the program's gradient over the kept ones; None where the
  variant has no particles;
- ``witness(cfg, traffic, seed, device)``: ``readings.py
  --witness-seeds``'s reading, or None.

The mix itself holds the rest as data: the kernel sources to build
(``sources``), the launch counts a window step must show
(``launches_per_step``), the kernel groups the trace reduces
(``kernel_groups``: per group and kind, a regex of its kernels' names and
one of its entry kernel, one per call) and those a traced run must hold
(``traced_kernels``, ``<group>.<kind>``).

``pathwise.py`` is ``PathwisePILCO``'s particle loss through K6. Classic
moment-matching PILCO on the cart-pole swing-up (``cartpole-mm-f64``) comes
as these new files:

- ``systems/mm.py``: ``MomentMatchingPILCO`` under ``use_fused_mm`` (K2,
  ``csrc/kexp_pair.cu``), its spans around the drift's and the policy's
  matches, ``COSTS`` None, no kept particles;
- ``reference/mm.py``: a plain-torch reference of the MM loss (exact
  Gaussian moments of the SE-kernel SVGP under uncertain inputs, the sin/cos
  encoder's moments, the squashed policy, the expected saturating cost) and
  its three Adam steps;
- ``traffic/mm-f64.json``: ``"system": "mm"``, ``"sources": ["kexp_pair"]``,
  K2's launch counts and kernel groups;
- the configuration, ``workloads/cartpole-mm-f64.json`` (the limits),
  ``counts/`` for K2 and the moment-matched step, and K2's roofline readers.
"""
