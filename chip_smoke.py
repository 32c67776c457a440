#!/usr/bin/env python3
"""Drive bito_tpu_torch's kernel paths once on one NVIDIA card.

    python3 chip_smoke.py

The workload is the flagship configuration at full width: a DS1-shaped
problem (27 taxa, 1,949 columns drawn from 934 distinct ones, made from a
seed), GTR+Gamma4 with bench.py's parameters, and a batch of 200 random
unrooted trees with trifurcating roots.  Eight paths run the eleven
kernels, the six tree kernels in two bodies each; a ninth, the VBPI
trainer, and a tenth, the rooted time-tree instance, run the paired
kernels as their users' calls reach them; an eleventh, the GP engine,
runs no hand-written kernel; a twelfth, the NNI search, runs the paired
LL kernel where its TP-likelihood scoring reaches it; a thirteenth, the
MG94 codon models, runs the paired kernels' A=64 bodies, also at 16
rate categories (codon-categories) and past 32 (wide, beside rows 1-6
past 32 on the flagship); a fourteenth,
the dist path, runs the pattern-sharded engines on two ranks of the card
(rows 1-4 and the A=64 bodies on every rank); a fifteenth, the graft
path, the driver's entry points (rows 1-2); then the leveled variant
and the VI command line with a checkpoint:
  - paired: the engine's default (kernel="auto"), the on-chip bodies of
    paired_ll and paired_grad (csrc/paired_*_onchip.cu);
  - categories: the same entry points at GTR+Gamma16 (CATEGORY_PATH_C),
    which auto took to the scan tape before the paired kernels took 9-32
    rate categories: the on-chip bodies on 16 lanes a pattern, counted
    for the JSON line's entries paired_ll_onchip@C16 and
    paired_grad_onchip@C16; then the same engine with kernel="chunked"
    and the per-node functions on its tapes, whose wrappers refused 9-32
    categories before the chunked and per-node kernels took them: their
    on-chip bodies, counted for chunked_ll_onchip@C16,
    chunked_grad_onchip@C16 (two op lanes a pattern),
    pernode_ll_onchip@C16 and pernode_grad_onchip@C16;
  - large: the same entry points on two trees of 921 taxa (128 patterns:
    a cherry comb and a balanced tree) past the on-chip bodies' limits,
    where the wrappers hand the LL over to the global body
    (csrc/paired_ll.cu) and the gradients to the checkpointed grad body
    (csrc/paired_grad_ckpt.cu; paired_grad.cu, the global grad body, is
    held in phase 2 and timed in phase 4 through its launcher, and runs
    on the wide-large path past 32 categories);
  - chunked: the engine with kernel="chunked", the on-chip bodies of
    chunked_ll (csrc/paired_ll_onchip.cu on the chunked tape) and of
    chunked_grad (csrc/chunked_grad_onchip.cu);
  - large-chunked: the engine with kernel="chunked" on the large path's
    trees, past the on-chip bodies' limits: the global bodies of
    chunked_ll (csrc/chunked_ll.cu) and chunked_grad (csrc/chunked_grad.cu);
  - per-node: pernode_log_likelihoods and pernode_ll_and_gradients on the
    engine's own tapes, driven as bito_tpu's scripts/bench_kernel_race.py
    drives their originals (the engine has no route to them): the on-chip
    bodies of pernode_ll (csrc/paired_ll_onchip.cu on the per-node tape)
    and of pernode_grad (csrc/pernode_grad_onchip.cu);
  - large-pernode: the same functions on the large path's trees, past the
    on-chip bodies' limits: the global bodies of pernode_ll
    (csrc/pernode_ll.cu) and pernode_grad (csrc/pernode_grad.cu);
  - perflab: the perf lab's entry points (bito_tpu_torch/perflab, the
    counterparts of bito_tpu's scripts/perf_lab.py, perf_pipe_lab.py and
    perf_static_probe.py) at few repetitions: the per-node grad kernel's
    variants on the same operands (variant_grad, and pernode_grad as
    their base, the on-chip body), the nine pipe experiments (pipe_cell),
    the 4-D and 3-D
    stream sums (stream_sum, two entry points) and the static chain's
    slopes (static_chain);
  - vbpi: the VBPI trainer (vi.burrito.Burrito over the unrooted instance,
    api/instances.py) at bito_tpu's config4 shape: an MCMC sample of
    VBPI_TREES random trees in a Nexus file with a translate table and a
    DS1-shaped FASTA (27 taxa, 1,949 columns, 934 distinct), JC69 with
    constant rates and a strict clock, the split branch model, the
    lognormal scalar model, the simple optimizer, VBPI_PARTICLES
    particles.  The instance hands its engine one shared model row, so
    every step's likelihoods and gradients take the paired on-chip bodies
    at one rate category (paired_ll_onchip, paired_grad_onchip), on a new
    topology set every step; the SBN's EM and topology gradients run in
    float64 on the card (sbn/device.py).  The instance parses the Nexus
    file, counts the support and builds every sample's indexer
    representations in the native library (bito_tpu_torch/_native,
    bitocore.cpp, built with g++ at first use);
  - rooted: the rooted instance (rooted_instance, api/instances.py) at
    the shape of the rooted oracle (tests/test_rooted.py): ROOTED_TAXA
    dated taxa, a batch of BATCH random time trees with bifurcating roots
    (names t<i>_<date>, joins 0.5-10 years apart, branch lengths height
    differences; _synthetic.dated_trees_newick) over a DS1-shaped
    alignment (1,949 columns, 934 distinct), GTR+Weibull4 with the
    oracle's parameters (ROOTED_PARAMS: Weibull shape 0.1), a strict
    clock at rate ROOTED_RATE on every branch, so substitution lengths
    from 0.0005.  It parses the
    trees with the native parser, reads the dates from the names,
    prepares the model, asks for the log likelihoods with and without the
    log-det Jacobian and for every gradient key of phylo_gradients, then
    trains the SBN by simple average and asks for the unconditional
    subsplit probabilities.  The likelihoods and branch gradients take
    the paired on-chip bodies (one shared model row); the model-parameter
    gradients take one reverse-mode pass over the scan tape (its postorder,
    then an adjoint preorder);
  - chunklab: the chunk lab (perflab/perf_chunk_lab.py, the counterpart of
    scripts/perf_chunk_lab.py) on the flagship: every name of the script
    at one sweep of 40 calls, all through chunk_variant
    (perflab/csrc/chunk_variant.cu: the on-chip LL body of
    treelike/csrc/paired_ll_onchip.cuh with the script's knobs);
  - gp: gp_instance (api/gp.py) on bito_tpu's config3 flow at DS1's shape:
    a synthetic credible set of 12 rooted trees over 27 taxa (each the
    first after 2 random NNIs; DS1's credible set is not in the
    repository) with the DS1-shaped alignment: make_dag, make_gp_engine,
    populate_plvs, compute_likelihoods, the per-PCSP LLs, one
    optimize_branch_lengths_once, estimate_branch_lengths(GP_TOL,
    GP_MAX_ITER), estimate_sbn_parameters, calculate_hybrid_marginals;
  - nni: bito_tpu's config5 searches through gp_instance (read a FASTA and
    a seed Newick, make_dag, make_tp_engine and its two take-first setters
    or make_gp_engine and take_first_branch_length, make_nni_engine,
    run_init, run_main_loop / run_post_loop), top-1, on inputs from
    _synthetic.write_nni_inputs (DS1 and six_taxon are not in the
    repository: a random rooted seed tree, its synthetic credible set with
    uniform weights, and an alignment simulated under JC69 along the seed
    after TRUTH_NNIS random NNIs): the faithful TP-likelihood search (the
    product path) at DS1's shape, 27 taxa and 1,949 columns (934
    distinct), NNI_ITERS iterations at opt_max NNI_OPT_MAX, its per-edge
    PVs host numpy and its batched candidate scorer in float64 on the
    card, with nni/search.py's posterior tracking; the TP engine's
    top_tree_log_likelihoods (the paired on-chip LL body at C = 1); the
    whole-tree NNIEngine at DS1's shape for NNI_WHOLE_ITERS iterations,
    with TP-likelihood scoring (optimize_selected_branches on the scan
    tape, then the paired on-chip LL body) and with parsimony (Sankoff's
    torch operations); and the GP-scored search on NNI_GP_TAXA taxa and
    NNI_GP_SITES columns, run to completion (at most NNI_GP_ITERS
    iterations);
  - codon: bito_tpu's config6 (bench_configs.py:263-366) at its shape:
    CodonSitePattern over 27 taxa and 649 codon columns drawn from 573
    distinct ones (_synthetic.codon_alignment; DS1 is not in the
    repository), CODON_TREES random unrooted topologies cycled to
    CODON_BATCH trees, MG94 with kappa 2.5, omega 0.3 and nucleotide
    frequencies (0.3, 0.2, 0.3, 0.2), constant rates: log_likelihoods,
    ll_and_branch_gradients and CODON_SWEEP branch_eval_fn calls over
    scaled branch lengths on auto, which takes the A=64 kernels
    (csrc/paired_ll_a64.cu, csrc/paired_grad_a64.cu: every 64x64 product
    on the tensor cores in 3xTF32) on uniformized transition matrices;
  - codon-categories: the same shape at MG94+Gamma16 (CODON_CATEGORY_C,
    Gamma shape CODON_WEIBULL), which auto took to the scan tape before
    the A=64 kernels took 9-32 rate categories: log_likelihoods, an
    ll_eval_fn call, ll_and_branch_gradients and CODON_CATEGORY_SWEEP
    branch_eval_fn calls on auto, counted for the JSON line's entries
    paired_ll_a64@C16 and paired_grad_a64@C16; then kernel="cuda" at 33
    categories, held to float64, and branch_eval_fn at
    CODON_WIDE_BATCH trees x 32 categories, over the launchers' slices
    of trees where their scratch does not fit in one launch;
  - wide: past 32 rate categories, where auto once took the scan tape
    and the forced routes raised: the flagship at GTR+Gamma64
    (WIDE_C) on auto, kernel="chunked" and the per-node functions, each
    launching its on-chip body with K = 2 categories a lane of 32 (rows
    1, 3 and 5 csrc/paired_ll_onchip.cu, rows 2, 4 and 6
    csrc/paired_grad_onchip.cu on their own tapes), counted for the JSON
    line's `<row>_onchip@C64` and `<row>_paired@C64` entries; then the
    large path's 921-taxon trees at GTR+Gamma64 on the same entry points
    (wide-large), where no warp of those bodies fits and each launches
    its global body's wide kernel (csrc/paired_lanes.cuh,
    csrc/pernode_lanes.cuh), counted for the `<row>@C64` entries; then
    config6's shape at MG94+Gamma48 (WIDE_CODON_C) on auto, the A=64
    kernels over the launchers' slices of trees, counted for the @C48
    entries (the wide-codon count); no scan tape call;
  - dist: the port's launcher (python -m bito_tpu_torch.dist.launch)
    starts DIST_RANKS ranks of this script (`--dist-worker gloo OUTDIR`)
    on the one card over Gloo, each holding half the patterns
    (TreeLikelihoodEngine.shard_patterns and GPEngine.shard_patterns):
    the flagship at full width on auto (paired_ll_onchip,
    paired_grad_onchip) and on chunked (chunked_ll_onchip,
    chunked_grad_onchip), LL-only and LL+gradients; the codon path's
    shape on auto (paired_ll_a64, paired_grad_a64); the GP engine at
    config3's shape in float64; the vbpi path's trainer with its instance
    engine sharded beside the same trainer unsharded (dist_vbpi).  Then one rank over NCCL (`--dist-worker
    nccl`), and NCCL asked for two ranks on one card, which the launcher
    refuses before any worker starts;
  - graft: the driver's entry points (bito_tpu_torch/graft_entry.py, the
    counterpart of bito_tpu's __graft_entry__.py): entry()'s forward on
    the card in float32 (batched GTR+Gamma4 LLs of 4 rooted trees of 8
    taxa x 256 patterns, paired_ll_onchip alone), then
    dryrun_multichip(DIST_RANKS): its six programs (a training step, the
    GP engine, the flagship engine, a VBPI step, a GP-scored NNI search,
    an MG94 engine on the scan tape) pattern-sharded over two Gloo ranks
    of the card, started through the port's launcher, whose flagship
    programs launch rows 1-2 on every rank;
  - leveled: the flagship's float64 engine with use_leveled (the
    levelized tapes, no hand-written kernel);
  - cli: `python -m bito_tpu_torch.vi.cli`'s benchmark (2 steps on a
    synthetic directory X with X_out.t and X.fasta at DS1's shape, on
    the card: the paired on-chip bodies at C = 1) and dag-to-dot; a
    Burrito checkpoint (utils/checkpoint.py) restored into a fresh one.

Phases, each printing its lines; any failure raises and exits non-zero:
  1. the card's name and power limit; build the CUDA kernels from the
     sources in the checkout (nvcc, at first use), with each kernel's
     registers and spills; the A=64 kernels' SASS (cuobjdump), which must
     hold HMMA or HGMMA instructions, and its most used opcodes.
  2. each kernel against its plain torch version in float64 on the same
     operands (both bodies of each tree kernel on the flagship's): LL
     relative error
     and gradient max-abs error over max |g|, both within 5e-5 (bench.py's
     on-device guard).  The probes: every variant of variant_grad the same
     way (nodot, which is not a likelihood, by equal non-finite places and
     finite values within the bounds); pipe_cell on the six experiments
     that fill their scratch, at 100 cells, on the script's ones block and
     on a block of small integers, and both stream sums, exactly on the
     integer block and, on a random bf16 block, within n u sum|x| of the
     float64 sums (n the groups a sum adds, u = 2^-24: the worst case of
     n float32 additions in any order);
     static_chain, both variants at every layout (1, 2 and 4 warps a
     column), within 1e-5 of max |out| against its float32 plain version.
     The rooted path's trees (bifurcating roots) through both paired
     on-chip kernels against their float64 plain versions within 5e-5.
     Both A=64 kernels against their float64 plain versions at the codon
     path's shape (C = 1) and at MG94+Weibull4 (C = 4, CODON_C4_BATCH
     trees), within A64_BOUND (1e-6, which one TF32 pass misses); their
     gradients nearer to the 3xTF32 emulation
     (paired.paired_ll_and_gradients_tf32, on the CPU) than to one TF32
     pass, on two trees; at the edge of float32's range
     (_synthetic.disagreeing_codons at CODON_EDGE_LENGTHS), finite and
     within A64_BOUND; the per-node functions at 64 states
     (pernode_log_likelihoods, pernode_ll_and_gradients: the A=64 kernels
     on the per-node tape) within A64_BOUND on CODON_PERNODE_BATCH trees,
     each launching each A=64 kernel once.  Both A=64 kernels at
     CODON_CATEGORY_COUNTS (9, 16, 32) categories at the codon path's
     shape on all CODON_BATCH trees, finite, the first CODON_REF_TREES
     trees' rows within A64_BOUND of their float64 plain versions, also
     with every branch CATEGORY_EDGE_LENGTH long and on the disagreeing
     codons, with each count's scratch a tree and the trees one launch
     takes; at CODON_CATEGORY_C the grad kernel nearer to the 3xTF32
     emulation than to one pass (one tree) and the per-node functions
     (codon_category_parity).
     Both paired kernels at CATEGORY_COUNTS (9, 16, 32) rate categories
     through their wrappers against their float64 plain versions within
     5e-5: on the flagship (the on-chip bodies), on the flagship with
     every branch CATEGORY_EDGE_LENGTH (1e-6) long, and on the large
     path's trees (the global bodies), each launching the body its plan
     names (category_parity); the chunked and per-node kernels (rows 3-6)
     the same way, and on the flagship also each body their plans do not
     name, through its launcher (category_rows_parity).
     Rows 1-6 at WIDE_COUNTS (33, 64) categories on the flagship's trees
     and at WIDE_SMALL (96, 128) on its first WIDE_REF_TREES: each
     wrapper (the on-chip bodies with K categories a lane where the plan
     fits, else the wide kernels) and every other body through its
     launcher (the K bodies forced, the global bodies' wide kernels), the
     first WIDE_REF_TREES trees within 5e-5 of their float64 plain
     versions, and rows 1b-2b at 33, 48 and 64 on CODON_REF_TREES trees
     of the codon shape within A64_BOUND (wide_parity).
     The paired route's prep kernel (models/csrc/transition_prep.cu,
     prep.transition_prep: P and dP at 4 states from the float64
     ingredients) against the torch ops it replaced on the flagship's
     trees at two draws of branch lengths each, at Gamma4, Gamma64 and
     the rooted oracle's shape 0.1 with branches 0 and 0.0005: every
     entry within one float32 ulp or 4e-16 absolute (prep_parity); phase
     3 counts its launches on every path whose engine takes the paired
     route's gradients at 4 states.
     chunk_variant's variants (v0, w4, w8, norescale, notips, fixstore,
     nodot, unroll) against their float64 plain versions on the
     flagship's chunked operands: the LL within 5e-5 relative (notips,
     whose LL is 0 up to rounding, within 5e-5 a site; nodot, not a
     likelihood, by equal non-finite rows and finite ones, per-site log
     values, within 5e-5).
  3. each path, with every launch count set to 0 just before it and read
     just after: its kernels must have launched and no other path's; the
     results (log_likelihoods, ll_and_branch_gradients, calls over scaled
     branch lengths, and ll_eval_fn on the chunked path) must be finite
     and agree with the float64 engine (the scan tape) within the phase-2
     bounds (on the wide path on its first WIDE_REF_TREES or
     CODON_REF_TREES trees, and no scan tape call may run); the float64
     gradients are checked against central differences.  On the perflab
     path the variants must agree with base (nodot aside), the filled pipe
     experiments with phase 2's plain outputs, both stream sums with each
     other and the sum of the ones block, and every slope (both variants at
     every layout) must be finite and not under its FMA floor; each is
     printed beside that floor, and each pipe experiment's us per cell
     beside both terms of its bound (perf_pipe_lab.pipe_bound_ms).
     On the vbpi path: the EM on the card in float64 against the numpy
     backend within 1e-10; one warm-up step, then VBPI_STEPS steps timed
     by phase (Burrito.gradient_step's phases, the card synchronised at
     every boundary) and estimate_elbo, with the launch counts read after
     them (only the two paired on-chip kernels, and no call of the scan
     tape); then the last sample's LL and gradients from the card in
     float32 against the float64 engine, and the paired kernels against
     their float64 plain versions, on those trees, within 5e-5; the
     topology gradients on the card against the numpy backend within
     1e-10; a finite ELBO; the native indexer built every representation
     of the steps (no call of the pure-Python one), and the last sample's
     native representations equal the pure-Python ones.
     On the rooted path: only the two paired on-chip kernels launched, and
     the scan tape ran only for the model gradients' reverse pass; finite
     outputs of every key; the log likelihoods (with and without the
     Jacobian) and every gradient key within 5e-5 of the same instance in
     float64 on the card (the scan tape); the unconditional subsplit
     probabilities in [0, 1]; the host time of each call and both
     kernels' times on the path's operands beside their bounds.
     On the chunklab path: only chunk_variant launched; v0's rows equal
     chunked_ll_onchip's on the same operands; w2, w4, w8, norescale,
     fixstore and unroll within 5e-5 of v0.  On the gp path: no
     hand-written kernel launched; the DAG's node and edge counts; finite
     PLVs and LLs; the log marginal and every per-PCSP LL at the start,
     the log marginal after estimate_branch_lengths and after
     estimate_sbn_parameters, and the hybrid marginals within 5e-5
     relative of the same flow in float64 on the card; the SBN parameters
     within Q_BOUND absolute of float64's, a limit that a control (the
     same softmax on float64's LLs rounded to Q_CONTROL_BITS significand
     bits) must exceed.  On the nni path: paired_ll_onchip launched from
     top_tree_log_likelihoods and from the whole-tree engine's scoring
     and no other kernel (the faithful, parsimony and GP-scored searches
     launch none); the top-tree LLs and the whole-tree engine's float32
     candidate scores within BOUND of the float64 engine on the same
     trees, each iteration from the float32 run's own state; Sankoff's
     scores on the card equal to its float64 version's; on the codon
     path: only the two A=64 kernels launched and no scan tape call ran,
     the results within A64_BOUND of the same engine in float64 on the
     card (the uniformized scan tape), the float64 gradients against central
     differences; on the codon-categories path the same on the first
     CODON_REF_TREES trees (the float64 engine on those trees), every
     result finite, kernel="cuda" at 33 categories launching both A=64
     kernels within A64_BOUND of float64, and the CODON_WIDE_BATCH-tree
     call's launches and first trees within A64_BOUND; the batched
     scorer's float64 scores on the card within SCORER_BOUND relative of
     the serial numpy scorer on the first and the last iteration's
     candidate sets (ROUNDED_BOUND where a Brent step was decided by
     rounding: the searches end at other points); the GP-scored search's
     float32 scores within BOUND of a float64 GP engine on the same
     grafted DAG from the float32 run's state, and a float32 GP engine
     refusing TF32; each search's iterations/s, an iteration split by
     phase (the engines' timer.phase names and the faithful search's
     score / accept / post, the card synchronised at each edge), the
     top-1 margins, and the torch operations on the card of one batched
     scorer call and of one GP-scored iteration.
     On the dist path, each rank (dist_worker; a failed check exits it
     non-zero, and a failed or silent rank makes the launcher and this
     script fail): on each route the launch counts set to 0 just before
     the sharded LL and LL+gradient calls and read after them (the
     route's two kernels, no other); the results the same on every rank
     and within 5e-5 (flagship) or A64_BOUND (codon) of the unsharded
     float64 engine, printed beside their distance from the unsharded
     float32 kernels; ms a call on the rank (host clock after a barrier,
     the card synchronised around each all_reduce) and the all_reduces'
     share of it, the unsharded call's ms and each kernel wrapper's ms
     on the rank's operands; the GP engine's log marginal, per-PCSP LLs
     and (after one sweep) branch lengths within GP_DIST_BOUND of the
     unsharded engine (dist_gp), the same on every rank; the sharded VBPI
     trainer's last sample's LL and gradients, its ELBO and its SBN and
     scalar parameters after three steps within 5e-5 of the unsharded
     trainer's, the same trees drawn, and ms a step on the rank sharded
     and unsharded (dist_vbpi); the NCCL rank's
     auto call equal
     to the unsharded call.  On the graft path: only paired_ll_onchip
     launched by the forward, its LLs finite, of shape [4] and within 5e-5
     of the float64 plain version on the same inputs, its ms a call (CUDA
     events) beside the kernel's alone on the card's name and limit; the
     dryrun's OK line, each rank's results the same, its training step,
     flagship engine and VBPI engine (on the trainer's last sample)
     within 5e-5 of the float64 plain versions on the same inputs,
     unsharded, and each rank's launches of rows 1-2 (paired_ll_onchip
     and paired_grad_onchip both launched on every rank).  On the leveled path: within LEVELED_BOUND of
     the scan tape, no kernel launched, both calls' ms.  On the cli path:
     only the two paired on-chip kernels launched, a finite final ELBO,
     the two CSVs with bito_tpu's columns, the .dot file; the restored
     Burrito's parameters and Adam state bit-equal.
  4. CUDA-event times of each kernel, its plain version and, where one
     PyTorch call computes the same function, that call; pipe_cell, the
     stream sums and static_chain, whose wrappers' host work outlasts
     their kernels, are timed from the device instead, with torch.sum
     beside the stream sums (perflab.graph_ms: the launches into
     an output allocated once, captured in a CUDA graph, its replays
     between CUDA events); the least time the card could take for the
     same work (for pipe_cell the larger of its device-memory bytes and
     its scratch's shared-memory bytes at 128 B a clock an SM); every
     pipe experiment at every tile that fits (the rule of
     perf_pipe_lab.pipe_plan); every body of the tree
     kernels that takes the shape (the on-chip LL bodies in both stagings
     on all three tapes, the paired grad body in both, the checkpointed
     grad body, the global bodies), on the flagship and on trees of
     BODY_TAXA taxa (the per-node ones also of PERNODE_TAXA taxa; the
     paired ones also of CKPT_TAXA taxa), each held once against its
     float64 plain
     version within the phase-2 bound before it is timed, beside the body
     the wrappers choose; each engine route's
     LL+gradient evals/s; the host time of a new topology set at B=200 and
     B=1000; chunk_variant's variants each alone beside its bound, and the
     chunk lab's names as evals/s (the chunklab path's sweeps) with
     preponly's share of a call; the gp path's populate + per-PCSP pass
     (best of 3, the card synchronised) and its optimize sweep (the gp
     path's call) with the device kernels and torch operations each runs;
     paired_ll_onchip at the whole-tree NNI engine's last candidate batch
     (JC69, C = 1) beside its plain version and its bound; the codon
     path's LL+gradient evals/s on auto (the A=64 kernels) and on the
     float32 scan tape (TF32 off: bito_tpu's auto route at 64 states), and
     its device memory high-water mark; the A=64 kernels beside both
     bounds, at 3xTF32 on the tensor cores (PEAK_3XTF32, the JSON line's)
     and at float32 FMAs; the per-node functions at 64 states at the codon
     path's shape beside their plain versions; all with the card's name
     and limit; the paired kernels at CATEGORY_COUNTS categories on the
     flagship (their on-chip bodies, and at CATEGORY_PATH_C also the
     global bodies) beside their float32 plain versions and bounds, and
     at CATEGORY_PATH_C auto's and the chunked route's LL+gradient call
     beside the scan tape's (category_times); the chunked and per-node
     kernels the same way (category_rows_times); the A=64 kernels at
     CODON_CATEGORY_COUNTS beside their float32 plain versions and both
     bounds, auto's LL+gradient call and its device memory high-water
     mark at each count, and at CODON_CATEGORY_C the float32 scan tape's
     call (codon_category_times); rows 4 and 6 at PAIRED_ROWS_COUNTS (17,
     32), every body of each (paired_rows_times); rows 1-6 at WIDE_TIMED
     (33, 48, 64) categories on the flagship, each wrapper's K body
     beside the wide kernel forced on the same operands, and rows 1b-2b
     on WIDE_CODON_TREES trees of the codon shape beside their float32
     plain versions and bounds, with auto's, the chunked route's and the
     scan tape's LL+gradient call at each count (wide_times; the JSON
     line's @C64 and @C48 entries timed in the main loop at fewer calls,
     KERNELS' `reps`); the K bodies at every block of warps at
     K_WARPS_COUNTS beside the wide kernels (k_warps_times).
  5. one JSON line of the kernels, then the device line, last.

It has no CPU path: without a card it exits non-zero and prints no result.
"""
import collections
import contextlib
import csv
import dataclasses
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from functools import partial

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from bito_tpu_torch import (PRODUCT_DEVICE, PRODUCT_DTYPE, _native, _synthetic,
                            graft_entry)
from bito_tpu_torch.convert import gp_state, gp_state_from_numpy, params_from_numpy
from bito_tpu_torch.core.newick import parse_newick_text
from bito_tpu_torch.core.site_pattern import CodonSitePattern, SitePattern
from bito_tpu_torch.models.phylo_model import PhyloModel, PhyloModelSpecification
from bito_tpu_torch.models.substitution import uniformized_terms
from bito_tpu_torch.perflab import (GRAPH_TIMING, card_line, cuda_ms,
                                    graph_ms, max_sm_clock_mhz,
                                    perf_chunk_lab, perf_lab, perf_pipe_lab,
                                    perf_static_probe)
from bito_tpu_torch.api.gp import gp_instance
from bito_tpu_torch.dag.graft import graft_node_pairs
from bito_tpu_torch.gp.engine import GPEngine, _sbn_segment_softmax
from bito_tpu_torch.nni.engine import NNIEngine
from bito_tpu_torch.nni.golden import nni_sort_key
from bito_tpu_torch.nni.search import PosteriorProbabilityMaps, SearchResults
from bito_tpu_torch.parsimony.sankoff import SankoffHandler
from bito_tpu_torch.tp import batch_scorer
from bito_tpu_torch.api.instances import rooted_instance, unrooted_instance
from bito_tpu_torch.sbn import maps as sbn_maps
from bito_tpu_torch.treelike import (_kernels, chunked, paired, pernode, prep,
                                     pruning)
from bito_tpu_torch.treelike.engine import TreeLikelihoodEngine
from bito_tpu_torch.vi import cli as vi_cli
from bito_tpu_torch.vi.burrito import Burrito
from bito_tpu_torch.dist import mesh as dist_mesh
from bito_tpu_torch.dist import multihost
from bito_tpu_torch.utils import checkpoint

SEED = 0
BATCH = 200
SWEEP = 40
BOUND = 5e-5  # bench.py's on-device parity guard
# The A=64 kernels against float64: 3xTF32 reads at most 2.7e-7, one TF32
# pass at least 3.1e-5 on the gradients (tests/test_torch_a64_tf32.py's
# emulation), so this limit, unlike BOUND, tells the two apart.
A64_BOUND = 1e-6
# phase 2's range cases: branch lengths of _synthetic.disagreeing_codons
CODON_EDGE_LENGTHS = (1e-6, 1e-8)
PARAMS = _synthetic.GTR_GAMMA4_PARAMS  # bench.py's
LAB_REPS = 5  # CUDA-event repetitions of each perf-lab measurement here
CELLS = perf_pipe_lab.CELLS  # the pipe lab's cells, 100
PROBES = "bito_tpu_torch/perflab/csrc/"
LARGE_CHERRIES = 460  # the large path's trees: 921 taxa
LARGE_PATTERNS = 128
# phase 4's further shapes
BODY_TAXA = (64, 96, 128, 144, 160, 192, 256, 320, 400)
CKPT_TAXA = 500  # and the paired bodies at rbcL 500's tree size
# phase 2 holds the checkpointed grad body on the flagship's trees at
# this many ops a clade, so that they have ops above the cuts
CKPT_FLAGSHIP_OPS = 8
PERNODE_TAXA = (76, 84)  # and the per-node bodies' hand-over between them
TOPOLOGY_BATCH = 1000  # phase 4's larger new topology set
# the vbpi path: bito_tpu's bench_configs.py config4 (vip/benchmark.py)
VBPI_TREES = 10  # the MCMC sample (config4 reads DS1.subsampled_10.t)
VBPI_PARTICLES = 20
VBPI_STEPS = 5
VBPI_SPEC = ("JC69", "constant", "strict")
VBPI_EM = (0.0, 30, 0.0)  # alpha, iterations, score epsilon
# 9-32 rate categories (the paired kernels' lane bodies, GTR+Gamma C):
# phase 2's counts, the categories path's count and its scaled calls, and
# phase 2's short branches (every branch this long)
CATEGORY_COUNTS = (9, 16, 32)
CATEGORY_PATH_C = 16
CATEGORY_SWEEP = 4
CATEGORY_EDGE_LENGTH = 1e-6
# the rooted path: the rooted oracle's shape (tests/test_rooted.py)
ROOTED_TAXA = 69  # fluA's count
ROOTED_SPEC = ("GTR", "weibull+4", "strict")
ROOTED_RATE = 0.001  # every branch's strict-clock rate
# test_rooted.py's GTR frequencies and rates, and its Weibull shape
ROOTED_PARAMS = {"substitution_model_frequencies": [0.1, 0.2, 0.3, 0.4],
                 "substitution_model_rates": [0.05, 0.1, 0.15, 0.20, 0.25,
                                              0.25],
                 "site_model_parameters": [0.1]}
ROOTED_KEYS = ("branch_lengths", "ratios_root_height", "clock_model",
               "clock_model_rates", "substitution_model", "site_model")
# the gp path: bito_tpu's bench_configs.py config3 (GP on DS1's credible
# set, 140 edges) at DS1's shape, on a synthetic credible set
# bito_tpu's GP-scored NNI engine's estimate after an acceptance
# (nni/engine.py:560)
GP_TOL, GP_MAX_ITER = 1e-3, 5
GP_REPS = 3  # phase 4: best of 3 populate passes
# the SBN parameters' absolute limit against float64, and the control that
# must exceed it: the softmax on float64's LLs rounded to this many
# significand bits (float32 keeps 24)
Q_BOUND, Q_CONTROL_BITS = 1e-2, 18
# the nni path: bito_tpu's bench_configs.py config5 (the faithful
# TP-likelihood search on DS1, 20 iterations at opt_max 1, and the
# GP-scored search on six_taxon, run to completion), on synthetic inputs
NNI_ITERS, NNI_OPT_MAX = 20, 1
NNI_WHOLE_ITERS = 3  # the whole-tree engines at DS1's shape
NNI_GP_TAXA, NNI_GP_SITES, NNI_GP_ITERS = 6, 200, 10
# the batched scorer against the serial one: relative, and where a Brent
# step was decided by rounding (the searches end at other points), by the
# LL reached (tests/test_torch_batch_scorer.py)
SCORER_BOUND, ROUNDED_BOUND = 1e-10, 1e-7
# the codon path: bito_tpu's bench_configs.py config6 (MG94 through the
# product engine on DS1 read as codons: 27 taxa, 649 triplets, 573
# distinct; its 10 trees cycled to a batch of 128; a sweep of 10 calls
# over scaled branch lengths), on a synthetic alignment and random trees
CODON_BATCH, CODON_TREES, CODON_SWEEP = 128, 10, 10
CODON_PARAMS = {"substitution_model_rates": np.array([2.5, 0.3]),
                "substitution_model_frequencies": np.array([0.3, 0.2, 0.3,
                                                            0.2])}
CODON_C4_BATCH, CODON_WEIBULL = 16, 0.8  # phase 2's MG94+Weibull4 check
CODON_PERNODE_BATCH = 8  # phase 2's per-node functions at 64 states
# The codon path at 9-32 rate categories (MG94+Gamma C, shape
# CODON_WEIBULL, at config6's shape): phase 2's counts, the
# codon-categories path's count and its scaled calls, the trees of a
# batch held to float64 (the plain version holds its partials in float64,
# about 80 GB at C = 32 over CODON_BATCH trees; each tree's rows depend on
# that tree alone), and phase 3's larger batch at the largest count
CODON_CATEGORY_COUNTS = (9, 16, 32)
CODON_CATEGORY_C = 16
CODON_CATEGORY_SWEEP = 4
CODON_REF_TREES = 8
CODON_WIDE_BATCH = 200
# The wide path: every tree kernel past 32 rate categories.  Phase 2
# holds each kernel at WIDE_COUNTS (rows 1-6 on the flagship's trees, the
# first WIDE_REF_TREES held to float64; rows 1b-2b also at WIDE_CODON_C, on
# CODON_REF_TREES trees of config6's shape); phase 3 drives the flagship at
# GTR+Gamma WIDE_C on auto, kernel="chunked" and the per-node functions
# (WIDE_SWEEP scaled calls each) and config6's shape at MG94+Gamma
# WIDE_CODON_C on auto; phase 4 times them at WIDE_TIMED, rows 1b-2b on
# WIDE_CODON_TREES trees (their float32 plain version at 128 trees and 48
# categories would take 59 GB beside the kernels' scratch).
WIDE_COUNTS = (33, 64)
WIDE_SMALL = (96, 128)
WIDE_C = 64
WIDE_CODON_C = 48
WIDE_TIMED = (33, 48, 64)
WIDE_REF_TREES = 20
WIDE_CODON_TREES = 32
WIDE_SWEEP = 2
WIDE_ROWS = ("paired_ll", "paired_grad", "chunked_ll", "chunked_grad",
             "pernode_ll", "pernode_grad")
PEAK_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
# H100 SXM dense TF32 on the tensor cores over three passes: the rate of a
# float32-accurate product in 3xTF32 (the A=64 kernels)
PEAK_3XTF32 = 495e12 / 3
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s
# name -> its source, its TPU kernel, the launcher that counts its
# launches, its path and the other paths that launch it (the graft path's
# dryrun launches rows 1-2 in its ranks' processes, which count them
# there: graft_path reads them from graft_entry.dryrun_results)
KERNELS = {
    "paired_ll_onchip": dict(
        source="bito_tpu_torch/treelike/csrc/paired_ll_onchip.cu",
        replaces="bito_tpu/treelike/pallas_paired.py:423",
        wrapper=paired.paired_ll_onchip, path="paired",
        also=("vbpi", "rooted", "nni", "cli", "categories", "graft",
              "wide")),
    "paired_grad_onchip": dict(
        source="bito_tpu_torch/treelike/csrc/paired_grad_onchip.cu",
        replaces="bito_tpu/treelike/pallas_paired.py:446",
        wrapper=paired.paired_grad_onchip, path="paired",
        also=("vbpi", "rooted", "cli", "categories", "wide")),
    # Rows 1-2 at CATEGORY_PATH_C categories (16 lanes a pattern, the count
    # read at run time): the same launchers, counted on the categories path
    "paired_ll_onchip@C16": dict(
        source="bito_tpu_torch/treelike/csrc/paired_ll_onchip.cu",
        replaces="bito_tpu/treelike/pallas_paired.py:423",
        wrapper=paired.paired_ll_onchip, path="categories",
        also=("paired", "vbpi", "rooted", "nni", "cli", "graft", "wide")),
    "paired_grad_onchip@C16": dict(
        source="bito_tpu_torch/treelike/csrc/paired_grad_onchip.cu",
        replaces="bito_tpu/treelike/pallas_paired.py:446",
        wrapper=paired.paired_grad_onchip, path="categories",
        also=("paired", "vbpi", "rooted", "cli", "wide")),
    # Rows 3-6 at CATEGORY_PATH_C categories: the chunked route's and the
    # per-node functions' on-chip bodies, counted on the categories path
    "chunked_ll_onchip@C16": dict(
        source="bito_tpu_torch/treelike/csrc/paired_ll_onchip.cu",
        replaces="bito_tpu/treelike/pallas_chunked.py:384",
        wrapper=chunked.chunked_ll_onchip, path="categories",
        also=("chunked", "wide")),
    "chunked_grad_onchip@C16": dict(
        source="bito_tpu_torch/treelike/csrc/chunked_grad_onchip.cu",
        replaces="bito_tpu/treelike/pallas_chunked.py:404",
        wrapper=chunked.chunked_grad_onchip, path="categories",
        also=("chunked",)),
    "pernode_ll_onchip@C16": dict(
        source="bito_tpu_torch/treelike/csrc/paired_ll_onchip.cu",
        replaces="bito_tpu/treelike/pallas_pruning.py:90",
        wrapper=pernode.pernode_ll_onchip, path="categories",
        also=("pernode", "wide")),
    "pernode_grad_onchip@C16": dict(
        source="bito_tpu_torch/treelike/csrc/pernode_grad_onchip.cu",
        replaces="bito_tpu/treelike/pallas_pruning.py:179",
        wrapper=pernode.pernode_grad_onchip, path="categories",
        also=("pernode", "perflab")),
    "paired_ll": dict(
        source="bito_tpu_torch/treelike/csrc/paired_ll.cu",
        replaces="bito_tpu/treelike/pallas_paired.py:423",
        wrapper=paired.paired_ll_global, path="large", also=("wide-large",)),
    "paired_grad": dict(
        source="bito_tpu_torch/treelike/csrc/paired_grad.cu",
        replaces="bito_tpu/treelike/pallas_paired.py:446",
        wrapper=paired.paired_grad_global, path="wide-large"),
    # The grad kernel's body past the on-chip limit at 1-8 categories:
    # the large path's gradients; held and timed at CKPT_TAXA taxa, the
    # shape the route gives it (ckpt_entry)
    "paired_grad_ckpt": dict(
        source="bito_tpu_torch/treelike/csrc/paired_grad_ckpt.cu",
        replaces="bito_tpu/treelike/pallas_paired.py:446",
        wrapper=paired.paired_grad_ckpt, path="large", reps=(2, 10, 1)),
    "chunked_ll_onchip": dict(
        source="bito_tpu_torch/treelike/csrc/paired_ll_onchip.cu",
        replaces="bito_tpu/treelike/pallas_chunked.py:384",
        wrapper=chunked.chunked_ll_onchip, path="chunked",
        also=("categories", "wide")),
    "chunked_ll": dict(
        source="bito_tpu_torch/treelike/csrc/chunked_ll.cu",
        replaces="bito_tpu/treelike/pallas_chunked.py:384",
        wrapper=chunked.chunked_ll_global, path="large-chunked",
        also=("wide-large",)),
    "chunked_grad_onchip": dict(
        source="bito_tpu_torch/treelike/csrc/chunked_grad_onchip.cu",
        replaces="bito_tpu/treelike/pallas_chunked.py:404",
        wrapper=chunked.chunked_grad_onchip, path="chunked",
        also=("categories",)),
    "chunked_grad": dict(
        source="bito_tpu_torch/treelike/csrc/chunked_grad.cu",
        replaces="bito_tpu/treelike/pallas_chunked.py:404",
        wrapper=chunked.chunked_grad_global, path="large-chunked",
        also=("wide-large",)),
    "pernode_ll_onchip": dict(
        source="bito_tpu_torch/treelike/csrc/paired_ll_onchip.cu",
        replaces="bito_tpu/treelike/pallas_pruning.py:90",
        wrapper=pernode.pernode_ll_onchip, path="pernode",
        also=("categories", "wide")),
    "pernode_ll": dict(
        source="bito_tpu_torch/treelike/csrc/pernode_ll.cu",
        replaces="bito_tpu/treelike/pallas_pruning.py:90",
        wrapper=pernode.pernode_ll_global, path="large-pernode",
        also=("wide-large",)),
    "pernode_grad_onchip": dict(
        source="bito_tpu_torch/treelike/csrc/pernode_grad_onchip.cu",
        replaces="bito_tpu/treelike/pallas_pruning.py:179",
        wrapper=pernode.pernode_grad_onchip, path="pernode",
        also=("perflab", "categories")),
    "pernode_grad": dict(
        source="bito_tpu_torch/treelike/csrc/pernode_grad.cu",
        replaces="bito_tpu/treelike/pallas_pruning.py:179",
        wrapper=pernode.pernode_grad_global, path="large-pernode",
        also=("wide-large",)),
    "variant_grad": dict(
        source=PROBES + "variant_grad.cu", replaces="scripts/perf_lab.py:36",
        wrapper=perf_lab.variant_ll_and_gradients, path="perflab"),
    "pipe_cell": dict(
        source=PROBES + "pipe_cell.cu",
        replaces="scripts/perf_pipe_lab.py:29",
        wrapper=perf_pipe_lab.pipe_cell, path="perflab"),
    "stream_sum_4d": dict(
        source=PROBES + "stream_sum.cu",
        replaces="scripts/perf_pipe_lab.py:101",
        wrapper=perf_pipe_lab.stream_sum_4d, path="perflab"),
    "stream_sum_3d": dict(
        source=PROBES + "stream_sum.cu",
        replaces="scripts/perf_pipe_lab.py:109",
        wrapper=perf_pipe_lab.stream_sum_3d, path="perflab"),
    "static_chain": dict(
        source=PROBES + "static_chain.cu",
        replaces="scripts/perf_static_probe.py:50",
        wrapper=perf_static_probe.static_chain, path="perflab"),
    "chunk_variant": dict(
        source=PROBES + "chunk_variant.cu",
        replaces="scripts/perf_chunk_lab.py:60",
        wrapper=perf_chunk_lab.chunk_variant, path="chunklab"),
    "paired_ll_a64": dict(
        source="bito_tpu_torch/treelike/csrc/paired_ll_a64.cu",
        replaces="bito_tpu/treelike/pallas_paired.py:423",
        wrapper=paired.paired_ll_a64, path="codon", peak=PEAK_3XTF32,
        also=("codon-categories", "wide-codon")),
    "paired_grad_a64": dict(
        source="bito_tpu_torch/treelike/csrc/paired_grad_a64.cu",
        replaces="bito_tpu/treelike/pallas_paired.py:446",
        wrapper=paired.paired_grad_a64, path="codon", peak=PEAK_3XTF32,
        also=("codon-categories", "wide-codon")),
    # Rows 1b-2b at CODON_CATEGORY_C categories: the same launchers,
    # counted on the codon-categories path
    "paired_ll_a64@C16": dict(
        source="bito_tpu_torch/treelike/csrc/paired_ll_a64.cu",
        replaces="bito_tpu/treelike/pallas_paired.py:423",
        wrapper=paired.paired_ll_a64, path="codon-categories",
        peak=PEAK_3XTF32, also=("codon", "wide-codon")),
    "paired_grad_a64@C16": dict(
        source="bito_tpu_torch/treelike/csrc/paired_grad_a64.cu",
        replaces="bito_tpu/treelike/pallas_paired.py:446",
        wrapper=paired.paired_grad_a64, path="codon-categories",
        peak=PEAK_3XTF32, also=("codon", "wide-codon")),
    # Rows 1-6 at WIDE_C categories, a lane of 32 holding two of them: the
    # on-chip bodies with K = 2 places a lane (`<row>_onchip@C64`; rows 4
    # and 6 on the paired grad body, `<row>_paired@C64`), counted on the
    # wide path (the flagship), and the global bodies' wide kernels
    # (`<row>@C64`), counted on the wide-large path (the 921-taxon trees)
    # and timed forced on the flagship; and rows 1b-2b at WIDE_CODON_C,
    # counted on the wide-codon path.  Phase 4 times them at fewer calls
    # (`reps`: plain calls, kernel calls, plain warm-up calls)
    **{f"{row}@C{WIDE_C}": dict(
        source=f"bito_tpu_torch/treelike/csrc/{body}",
        replaces=f"bito_tpu/treelike/{tpu}", wrapper=wrapper, path="wide",
        also=also, reps=(2, 10, 1))
       for row, body, tpu, wrapper, also in (
           ("paired_ll_onchip", "paired_ll_onchip.cu", "pallas_paired.py:423",
            paired.paired_ll_onchip, ("paired", "vbpi", "rooted", "nni",
                                      "cli", "categories", "graft")),
           ("paired_grad_onchip", "paired_grad_onchip.cu",
            "pallas_paired.py:446", paired.paired_grad_onchip,
            ("paired", "vbpi", "rooted", "cli", "categories")),
           ("chunked_ll_onchip", "paired_ll_onchip.cu",
            "pallas_chunked.py:384", chunked.chunked_ll_onchip,
            ("chunked", "categories")),
           ("chunked_grad_paired", "paired_grad_onchip.cu",
            "pallas_chunked.py:404", chunked.chunked_grad_paired, ()),
           ("pernode_ll_onchip", "paired_ll_onchip.cu",
            "pallas_pruning.py:90", pernode.pernode_ll_onchip,
            ("pernode", "categories")),
           ("pernode_grad_paired", "paired_grad_onchip.cu",
            "pallas_pruning.py:179", pernode.pernode_grad_paired, ()))},
    **{f"{row}@C{WIDE_C}": dict(
        source=f"bito_tpu_torch/treelike/csrc/{lanes}",
        replaces=f"bito_tpu/treelike/{tpu}", wrapper=wrapper,
        path="wide-large", also=(large,) if large else (), reps=(2, 10, 1))
       for row, lanes, tpu, wrapper, large in (
           ("paired_ll", "paired_lanes.cuh", "pallas_paired.py:423",
            paired.paired_ll_global, "large"),
           ("paired_grad", "paired_lanes.cuh", "pallas_paired.py:446",
            paired.paired_grad_global, None),
           ("chunked_ll", "paired_lanes.cuh", "pallas_chunked.py:384",
            chunked.chunked_ll_global, "large-chunked"),
           ("chunked_grad", "paired_lanes.cuh", "pallas_chunked.py:404",
            chunked.chunked_grad_global, "large-chunked"),
           ("pernode_ll", "pernode_lanes.cuh", "pallas_pruning.py:90",
            pernode.pernode_ll_global, "large-pernode"),
           ("pernode_grad", "pernode_lanes.cuh", "pallas_pruning.py:179",
            pernode.pernode_grad_global, "large-pernode"))},
    **{f"{name}@C{WIDE_CODON_C}": dict(
        source=f"bito_tpu_torch/treelike/csrc/{name}.cu",
        replaces=f"bito_tpu/treelike/pallas_paired.py:{line}",
        wrapper=wrapper, path="wide-codon", peak=PEAK_3XTF32,
        also=("codon", "codon-categories"), reps=(2, 10, 1))
       for name, line, wrapper in (
           ("paired_ll_a64", 423, paired.paired_ll_a64),
           ("paired_grad_a64", 446, paired.paired_grad_a64))},
    # The paired route's prep at 4 states (P and dP from the float64
    # ingredients), which bito_tpu left to XLA: every path whose engine
    # takes the paired route's gradients at 4 states launches it
    "transition_prep": dict(
        source="bito_tpu_torch/models/csrc/transition_prep.cu",
        replaces="none: bito_tpu/treelike/pallas_pruning.py:383 "
                 "prepare_inputs_grad_q, left to XLA",
        wrapper=prep.transition_prep, path="paired",
        also=("categories", "large", "vbpi", "rooted", "cli", "wide",
              "wide-large")),
}
# The A=64 kernels' __global__ functions, whose SASS phase 1 reads
TENSOR_KERNELS = ("paired_ll_a64_kernel", "paired_grad_a64_kernel")


def check(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def rel_err(x, ref):
    return ((x.double() - ref.double()).abs() / ref.double().abs()).max().item()


def norm_err(x, ref):
    return ((x.double() - ref.double()).abs().max()
            / ref.double().abs().max()).item()


def ptxas_usage(log):
    """[(kernel, spill line, register line)] from nvcc's -Xptxas -v output,
    each kernel named as `paired_grad_kernel<4>` or
    `variant_grad_kernel<26,51,1,true>`."""
    usage, kernel, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\w*?([a-z][a-z0-9_]*_kernel)"
                      r"(I(?:L[ib]\d+E)+E)?", line)
        if m:
            args = re.findall(r"L([ib])(\d+)E", m.group(2) or "")
            kernel = m.group(1) + (
                "<" + ",".join(v if t == "i" else ("false", "true")[int(v)]
                               for t, v in args) + ">" if args else "")
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line and kernel:
            usage.append((kernel, spill, line.split(":", 1)[-1].strip()))
            kernel = None
    return usage


def flagship():
    """The flagship workload: (trees, SitePattern, PhyloModel)."""
    text, alignment = _synthetic.ds1_shaped(SEED, BATCH)
    coll = parse_newick_text(text)
    sp = SitePattern(alignment, coll.taxon_names)
    return coll.trees, sp, PhyloModel(PhyloModelSpecification("GTR", "gamma+4"))


def large_trees():
    """The large path's workload: two trees of 2 * LARGE_CHERRIES + 1 taxa
    over LARGE_PATTERNS columns, a cherry comb (whose postorder keeps a
    third of its partials live) and a balanced tree (whose chunked
    schedule keeps half of them live): (trees, SitePattern, PhyloModel)."""
    coll = parse_newick_text(
        _synthetic.cherry_comb_newick(SEED, LARGE_CHERRIES, 1)
        + _synthetic.balanced_newick(SEED, 2 * LARGE_CHERRIES + 1, 1))
    aln = _synthetic.random_alignment(SEED + 1, coll.taxon_names,
                                      LARGE_PATTERNS)
    return (coll.trees, SitePattern(aln, coll.taxon_names),
            PhyloModel(PhyloModelSpecification("GTR", "gamma+4")))


def body_shape(taxa):
    """One of phase 4's further shapes: BATCH random unrooted trees of
    `taxa` taxa over 1,024 distinct columns, GTR+Gamma4."""
    names = _synthetic.taxon_names(taxa)
    coll = parse_newick_text(_synthetic.random_trees_newick(
        SEED + 2, taxa, BATCH))
    aln = _synthetic.random_alignment(SEED + 3, names, 1024)
    return (coll.trees, SitePattern(aln, coll.taxon_names),
            PhyloModel(PhyloModelSpecification("GTR", "gamma+4")))


def paired_bodies(label, eng, trees, params, card):
    """Phase 4's paired bodies side by side on one shape: every body that
    takes the shape (an on-chip staging where one warp of patterns fits,
    the checkpointed grad body on its schedule at CKPT_OPS ops a clade, the
    global body always) is held once against the float64 plain version on
    the same operands, within BOUND, then timed twice in turns.  Prints
    one line; returns {body: ms}."""
    enc = eng.encode(trees)
    eig, rates, props, clock = eng._model_ingredients(params, len(trees))
    pi, prop = prep.kernel_model(eig, props)
    P, dP = prep.prepare_inputs_grad_q(
        eig, rates, clock, eng.branch_length_matrix(trees, enc))
    dst, tip, src, e, mask = eng._paired_tapes(enc)
    on = eng._onchip_tape(enc)
    tips, w = eng._kernel_tips, eng._kernel_weights
    M, N1 = dst.shape[1], P.shape[1]

    calls, labels = ll_bodies(
        on.ll_rows, M, N1,
        lambda plan: paired.paired_ll_onchip(dst, on, e, P, tips, pi, prop,
                                             plan) @ w,
        lambda: paired.paired_ll_global(dst, tip, e, P, tips, pi, prop) @ w)
    for ring in (False, True):
        plan = paired.onchip_plan("grad", on.grad_rows, M, N1, 4, ring)
        if plan is not None:
            key = "grad onchip " + ("ring" if ring else "staged")
            labels[key] = (f"{key} ({plan.cols} patterns a block, "
                           f"{plan.smem} B)")
            calls[key] = lambda plan=plan: paired.finish_rows(
                *paired.paired_grad_onchip(dst, on, src, e, P, dP, tips, pi,
                                           prop, w, plan), mask, w)
    ckpt = on.ckpt or paired.ckpt_tape(
        *(x.cpu().numpy() for x in (dst, on.child, e, src)), P.device)
    plan = paired.ckpt_plan(ckpt.rows, 4)
    labels["grad ckpt"] = (f"grad ckpt ({plan.cols * plan.lanes // 32} "
                           f"warps, {ckpt.rows} rows, {ckpt.slots} slots)")
    calls["grad ckpt"] = lambda: paired.finish_rows(
        *paired.paired_grad_ckpt(ckpt, P, dP, tips, pi, prop, w), mask, w)
    calls["grad global"] = lambda: paired.finish_rows(
        *paired.paired_grad_global(dst, tip, src, e, P, dP, tips, pi, prop,
                                   w), mask, w)

    # The float64 plain version, a slice of trees at a time to bound its
    # scratch ([trees, 2M+3, C, 4, S] in float64, up to 2.5 GB); its time
    # is the host's launches, one set a slice.
    step = max(1, BATCH * 192 // max(M, 64) // 4)
    f64 = [x.double() for x in (tips, pi, prop, w)]
    refs = [paired.paired_ll_and_gradients_ref(
        dst[i:i + step], tip[i:i + step], src[i:i + step], e[i:i + step],
        mask[i:i + step], P[i:i + step].double(), dP[i:i + step].double(),
        *f64) for i in range(0, len(trees), step)]
    reps = body_reps(M)
    ms = held_then_timed(f"paired bodies, {label}", calls, refs, reps)
    print(f"# phase 4: paired bodies, {label} ({len(trees)} trees x "
          f"{eng.pattern_pad} patterns, {enc.num_taxa} taxa, M={M}; ms, "
          f"mean of two turns of {reps}): " + "; ".join(
              f"{labels.get(key, key)} {t:.4f}" for key, t in ms.items())
          + "; the wrappers take ll "
          f"{body_of(paired.onchip_plan('ll', on.ll_rows, M, N1, 4))}, grad "
          f"{body_of(paired.onchip_plan('grad', on.grad_rows, M, N1, 4), on)}"
          f"; on {card}")
    return ms


def body_reps(M):
    """Phase 4's repetitions of a body on a tape of M ops: 50 at the
    flagship, fewer as the calls grow (4 at 400 taxa)."""
    return max(4, 1600 // max(M, 32))


def held_then_timed(what, calls, refs, reps):
    """Hold each body's call once against the float64 plain version's
    (ll, grads) slices `refs` within BOUND ("ll ..." calls return ll,
    others (ll, grads)), then time each twice in turns, forward then
    backward.  Prints the errors; returns {body: mean ms}."""
    ll_ref = torch.cat([r[0] for r in refs])
    g_ref = torch.cat([r[1] for r in refs])
    errs = []
    for key, call in calls.items():
        out = call()
        torch.cuda.synchronize()
        if key.startswith("ll"):
            err = rel_err(out, ll_ref)
        else:
            err = max(rel_err(out[0], ll_ref), norm_err(out[1], g_ref))
        errs.append(f"{key} {err:.3e}")
        check(bool(torch.isfinite(out if key.startswith("ll")
                                  else out[1]).all()) and err <= BOUND,
              f"{what}: {key} parity")
    print(f"# phase 4: {what}, against the float64 plain version (LL rel "
          f"err, grad max-abs/max|g|; bound {BOUND:g}): " + ", ".join(errs))
    ms = {}
    for key in list(calls) + list(reversed(calls)):
        ms.setdefault(key, []).append(cuda_ms(calls[key], reps))
    return {key: sum(v) / len(v) for key, v in ms.items()}


def ll_bodies(rows, M, N1, onchip, global_body):
    """Phase 4's LL calls on one tape of the paired layout (the paired,
    chunked or per-node tape): the on-chip body (onchip(plan)) in each
    staging where one warp of patterns fits, the global body always; and
    the line's labels, the on-chip ones with their warps a block and
    bytes."""
    calls, labels = {}, {}
    for ring in (False, True):
        plan = paired.onchip_plan("ll", rows, M, N1, 4, ring)
        if plan is not None:
            key = "ll onchip " + ("ring" if ring else "staged")
            calls[key] = lambda plan=plan: onchip(plan)
            labels[key] = (f"{key} ({plan.cols * plan.lanes // 32} warps, "
                           f"{plan.smem} B)")
    calls["ll global"] = global_body
    return calls, labels


def body_of(plan, onchip=None):
    """The body a wrapper takes by `plan`, as the phase 4 lines name it:
    the paired grad wrapper (given its `onchip` tape) takes the
    checkpointed body where the tape has its schedule."""
    if plan is None:
        return "ckpt" if onchip is not None and onchip.ckpt else "global"
    return "onchip " + ("ring" if plan.ring else "staged")


def chunked_bodies(label, eng, trees, params, card):
    """Phase 4's chunked bodies side by side on one shape: the on-chip LL
    body in each staging and the on-chip grad body wherever one warp of
    patterns fits, the global bodies always, each held once against the
    float64 plain version on the same operands within BOUND, then timed
    twice in turns; the paired grad body on the chunked tape beside them
    where one warp of it fits.  Prints one line; returns {body: ms}."""
    enc = eng.encode(trees)
    eig, rates, props, clock = eng._model_ingredients(params, len(trees))
    pi, prop = prep.kernel_model(eig, props)
    P, dP = prep.prepare_inputs_grad(eig, rates, clock,
                                     eng.branch_length_matrix(trees, enc))
    dst, tip, e, row, mask = eng._chunked_tapes(enc)
    on = eng._chunked_onchip_tape(enc)
    tips, w = eng._kernel_tips, eng._kernel_weights
    MW, N1 = dst.shape[1], P.shape[1]
    calls, labels = ll_bodies(
        on.ll_rows, MW, N1,
        lambda plan: chunked.chunked_ll_onchip(dst, on, e, P, tips, pi, prop,
                                               plan) @ w,
        lambda: chunked.chunked_ll_global(dst, tip, e, P, tips, pi, prop) @ w)
    plan = chunked.onchip_plan(on.grad_rows, MW, N1, 4, least=1)
    if plan is not None:
        calls["grad onchip"] = lambda: chunked.finish_rows(
            *chunked.chunked_grad_onchip(dst, on, e, P, dP, tips, pi, prop,
                                         w, plan), row, mask, w)
    pplan = paired.onchip_plan("grad", on.grad_rows, MW, N1, 4, ring=True)
    if pplan is not None:
        calls["grad paired"] = lambda: paired.finish_rows(
            *chunked.chunked_grad_paired(dst, on, e, row, P, dP, tips, pi,
                                         prop, w, pplan), mask, w)
        labels["grad paired"] = (f"grad paired ({pplan.cols * 4 // 32} "
                                 f"warps, {pplan.smem} B)")
    calls["grad global"] = lambda: chunked.finish_rows(
        *chunked.chunked_grad_global(dst, tip, e, P, dP, tips, pi, prop, w),
        row, mask, w)
    # The float64 plain version, a slice of trees at a time to bound its
    # scratch ([trees, 2MW+2, C, 4, S] in float64, up to 2.5 GB).
    step = max(1, BATCH * 192 // max(MW, 64) // 4)
    f64 = [x.double() for x in (tips, pi, prop, w)]
    refs = [chunked.chunked_ll_and_gradients_ref(
        dst[i:i + step], tip[i:i + step], e[i:i + step], row[i:i + step],
        mask[i:i + step], P[i:i + step].double(), dP[i:i + step].double(),
        *f64) for i in range(0, len(trees), step)]
    reps = body_reps(MW)
    ms = held_then_timed(f"chunked bodies, {label}", calls, refs, reps)
    chosen = ("onchip" if chunked.onchip_plan(on.grad_rows, MW, N1, 4)
              else "paired" if chunked.paired_plan(on.grad_rows, MW, N1, 4)
              else "global")
    if plan is not None:
        labels["grad onchip"] = (
            f"grad onchip ({plan.cols} patterns, "
            f"{plan.cols * chunked.W * 4 // 32} warps, {plan.smem} B)")
    print(f"# phase 4: chunked bodies, {label} ({len(trees)} trees x "
          f"{eng.pattern_pad} patterns, {enc.num_taxa} taxa, MW={MW}, "
          f"{on.ll_rows} LL rows, {on.grad_rows} grad rows; ms, mean of two "
          f"turns of {reps}): " + "; ".join(
              f"{labels.get(key, key)} {t:.4f}" for key, t in ms.items())
          + f"; the wrappers take ll "
          f"{body_of(chunked.ll_plan(on.ll_rows, MW, N1, 4))}, grad "
          f"{chosen}; on {card}")
    return ms


def pernode_bodies(label, eng, trees, params, card):
    """Phase 4's per-node bodies side by side on one shape: the on-chip
    LL body in each staging and the on-chip grad body wherever one warp of
    patterns fits, the global bodies always, each held once against the
    float64 plain version on the same operands within BOUND, then timed
    twice in turns; the paired grad body on the per-node ops' paired tape
    beside them where one warp of it fits.  Prints one line; returns
    {body: ms}."""
    dev = eng.device
    enc = eng.encode(trees)
    eig, rates, props, clock = eng._model_ingredients(params, len(trees))
    pi, prop = prep.kernel_model(eig, props)
    P, dP = prep.prepare_inputs_grad(eig, rates, clock,
                                     eng.branch_length_matrix(trees, enc))
    post, pre, root = (torch.as_tensor(x, dtype=torch.int32, device=dev)
                       for x in (enc.post_ops, enc.pre_ops, enc.root))
    mask = torch.as_tensor(enc.edge_mask, dtype=torch.float32, device=dev)
    on = pernode.onchip_tape(enc.post_ops, enc.pre_ops, enc.root,
                             enc.num_taxa, enc.num_slots, dev)
    lt = pernode.ll_tape(enc.post_ops, enc.root, enc.num_taxa,
                         enc.num_slots, dev)
    tips, w = eng._kernel_tips, eng._kernel_weights
    N1, M = P.shape[1], post.shape[1]
    calls, labels = ll_bodies(
        lt.ll_rows, M, N1,
        lambda plan: pernode.pernode_ll_onchip(lt, P, tips, pi, prop,
                                               plan) @ w,
        lambda: pernode.pernode_ll_global(post, root, P, tips, pi, prop) @ w)
    plan = pernode.onchip_plan(on.rows, on.ints, N1, 4, least=1)
    if plan is not None:
        calls["grad onchip"] = lambda: pernode.finish_rows(
            *pernode.pernode_grad_onchip(on, root, P, dP, tips, pi, prop, w,
                                         plan), mask, w)
    pt = on.paired
    pplan = paired.onchip_plan("grad", pt.onchip.grad_rows,
                               pt.post_dst.shape[1], N1, 4, ring=True)
    if pplan is not None:
        calls["grad paired"] = lambda: paired.finish_rows(
            *pernode.pernode_grad_paired(pt, P, dP, tips, pi, prop, w,
                                         pplan), mask, w)
        labels["grad paired"] = (f"grad paired ({pplan.cols * 4 // 32} "
                                 f"warps, {pplan.smem} B)")
    calls["grad global"] = lambda: pernode.finish_rows(
        *pernode.pernode_grad_global(post, pre, root, P, dP, tips, pi, prop,
                                     w), mask, w)
    # The float64 plain version, a slice of trees at a time to bound its
    # scratch (partials and up values [trees, N1, C, 4, S] in float64).
    step = max(1, int(12e9) // (N1 * 16 * tips.shape[-1] * 8))
    f64 = [x.double() for x in (tips, pi, prop, w)]
    refs = [pernode.pernode_ll_and_gradients_ref(
        post[i:i + step], pre[i:i + step], root[i:i + step],
        mask[i:i + step], P[i:i + step].double(), dP[i:i + step].double(),
        *f64) for i in range(0, len(trees), step)]
    reps = body_reps(M)
    ms = held_then_timed(f"per-node bodies, {label}", calls, refs, reps)
    chosen = ("onchip" if pernode.onchip_plan(on.rows, on.ints, N1, 4)
              else "paired" if pernode.paired_plan(pt, N1, 4) else "global")
    if plan is not None:
        labels["grad onchip"] = (f"grad onchip ({plan.cols * 4 // 32} warps, "
                                 f"{plan.smem} B)")
    print(f"# phase 4: per-node bodies, {label} ({len(trees)} trees x "
          f"{eng.pattern_pad} patterns, {enc.num_taxa} taxa, M={M}, "
          f"{lt.ll_rows} LL rows, {on.rows} grad rows; ms, mean of two turns "
          f"of {reps}): " + "; ".join(
              f"{labels.get(key, key)} {t:.4f}" for key, t in ms.items())
          + f"; the wrappers take ll "
          f"{body_of(paired.onchip_plan('ll', lt.ll_rows, M, N1, 4))}, grad "
          f"{chosen}; on {card}")
    return ms


# -- 9-32 rate categories --------------------------------------------------
def category_model(C):
    return PhyloModel(PhyloModelSpecification("GTR", f"gamma+{C}"))


def paired_operands(eng, trees, params, bl=None):
    """(LL operands, LL+gradient operands, on-chip tape) of the paired
    kernels on `eng`'s tapes, at its branch lengths or `bl`."""
    enc = eng.encode(trees)
    bl = eng.branch_length_matrix(trees, enc) if bl is None else bl
    eig, rates, props, clock = eng._model_ingredients(params, len(trees))
    pi, prop = prep.kernel_model(eig, props)
    P, dP = prep.prepare_inputs_grad_q(eig, rates, clock, bl)
    dst, tip, src, e, mask = eng._paired_tapes(enc)
    tips, w = eng._kernel_tips, eng._kernel_weights
    return ((dst, tip, e, P, tips, pi, prop, w),
            (dst, tip, src, e, mask, P, dP, tips, pi, prop, w),
            eng._onchip_tape(enc))


def first_trees(ops, n, per_tree):
    """`ops` with its first `per_tree` operands (the tree-major ones) cut
    to the first `n` trees."""
    return [x[:n] for x in ops[:per_tree]] + list(ops[per_tree:])


def plain64(grad_ops, step=40):
    """The float64 plain version of the LL+gradient kernel on float32
    operands `grad_ops`, `step` trees at a time (its scratch [step, 2M+3,
    C, 4, S] in float64, 2.5 GB at the flagship's shape and C = 32)."""
    dst, tip, src, e, mask, P, dP, tips, pi, prop, w = grad_ops
    f64 = [x.double() for x in (tips, pi, prop, w)]
    parts = [paired.paired_ll_and_gradients_ref(
        dst[i:i + step], tip[i:i + step], src[i:i + step], e[i:i + step],
        mask[i:i + step], P[i:i + step].double(), dP[i:i + step].double(),
        *f64) for i in range(0, dst.shape[0], step)]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


def ckpt_parity(call, grad_ops, ckpt):
    """Phase 2's extra check of the checkpointed grad body: `call` (its
    launch through finish_rows on the flagship's float32 operands
    `grad_ops`, forced on the schedule `ckpt`, a shape the route never
    gives it) held within BOUND of the paired tape's float64 plain version
    and of its own, paired_grad_ckpt_ref, which interprets the same
    schedule in float64.  The kernels line holds it at the route's shape
    (ckpt_entry)."""
    dst, tip, src, e, mask, P, dP, tips, pi, prop, w = grad_ops
    ll_k, g_k = call()
    torch.cuda.synchronize()
    ll_p, g_p = plain64(grad_ops)
    f64 = [x.double() for x in (P, dP, tips, pi, prop, w)]
    ll_c, g_c = paired.finish_rows(*paired.paired_grad_ckpt_ref(
        ckpt.sched, ckpt.rows, ckpt.slots, *f64), mask.double(), f64[-1])
    err = norm_err(g_k, g_p)
    own = max(rel_err(ll_k, ll_c), norm_err(g_k, g_c))
    print(f"# phase 2: paired_grad_ckpt forced on the flagship's trees "
          f"({ckpt.rows} rows, {ckpt.slots} slots, {ckpt.sched.shape[1]} "
          f"entries a tree) LL rel err {rel_err(ll_k, ll_p):.3e}, grad "
          f"max-abs/max|g| {err:.3e} against the paired plain version in "
          f"float64; {own:.3e} against its own (paired_grad_ckpt_ref, "
          f"float64) (bound {BOUND:g})")
    check(rel_err(ll_k, ll_p) <= BOUND, "paired_grad_ckpt LL parity")
    check(err <= BOUND, "paired_grad_ckpt gradient parity")
    check(own <= BOUND, "paired_grad_ckpt against its plain version")


def ckpt_entry(eng, trees, sp, params):
    """The kernels line's paired_grad_ckpt entry, at the shape the route
    gives the body: `eng`'s BATCH trees of CKPT_TAXA taxa at GTR+Gamma4,
    whose tape carries the schedule.  The wrapper's call (the route takes
    the body: one launch, no other grad body) is held once against the
    float64 plain version within BOUND.  Returns the entry's (max-norm
    error, max abs error), (plain, kernel) calls, the plain version in
    float32 over slices of trees, and (FLOPs, bytes, None) of that
    call's operands."""
    ll_ops, grad_ops, on = paired_operands(eng, trees, params)
    dst, tip, src, e, mask, P, dP, tips, pi, prop, w = grad_ops
    M, N1 = dst.shape[1], P.shape[1]
    check(on.ckpt is not None and paired.onchip_plan(
        "grad", on.grad_rows, M, N1, 4) is None,
          f"the route gives {CKPT_TAXA} taxa the checkpointed grad body")
    bodies = (paired.paired_grad_onchip, paired.paired_grad_global,
              paired.paired_grad_ckpt)
    before = [f.launches for f in bodies]

    def kernel():
        return paired.paired_ll_and_gradients(*grad_ops, onchip=on)

    ll_k, g_k = kernel()
    torch.cuda.synchronize()
    check([f.launches - n for f, n in zip(bodies, before)] == [0, 0, 1],
          f"one checkpointed launch at {CKPT_TAXA} taxa")
    ll_p, g_p = plain64(grad_ops, step=20)
    err = (norm_err(g_k, g_p), (g_k.double() - g_p).abs().max().item())
    print(f"# phase 2: paired_grad_ckpt at {CKPT_TAXA} taxa, {len(trees)} "
          f"trees x {eng.pattern_pad} patterns ({on.ckpt.rows} rows, "
          f"{on.ckpt.slots} slots, {on.ckpt.sched.shape[1]} entries a "
          f"tree) LL rel err {rel_err(ll_k, ll_p):.3e}, grad max-abs/max|g| "
          f"{err[0]:.3e} (bound {BOUND:g}, plain version in float64 on the "
          f"same operands)")
    check(rel_err(ll_k, ll_p) <= BOUND and err[0] <= BOUND,
          f"paired_grad_ckpt parity at {CKPT_TAXA} taxa")

    def plain(step=20):
        return [paired.paired_ll_and_gradients_ref(
            *(x[i:i + step] for x in grad_ops[:7]), *grad_ops[7:])
            for i in range(0, len(trees), step)]

    enc = eng.encode(trees)
    fl = tree_flops(enc, sp, eng.model, len(trees))[1]
    moved = (nbytes(on.ckpt.sched, P, dP, tips, pi, prop, w, mask)
             + len(trees) * (1 + enc.num_slots) * 4)
    return err, (plain, kernel), (fl, moved, None)


PREP_WIDE_C = 64
PREP_TINY = 4e-16  # float64 rounding of O(1) terms at an entry near 0
PREP_OLD_SHAPE = 0.1  # the rooted oracle's Gamma shape
PREP_OLD_BRANCHES = (0.0, 0.0005)  # a zero and a strict clock's branch


def ulp_misses(a, b, tiny=PREP_TINY):
    """(entries of float32 `a` farther from `b` than one float32 ulp of the
    larger and than `tiny` absolute, the largest difference)."""
    big = torch.maximum(a.abs(), b.abs())
    ulp = (torch.nextafter(big, torch.full_like(big, math.inf)) - big
           ).double()
    diff = (a.double() - b.double()).abs()
    return int(((diff > ulp) & (diff > tiny)).sum()), diff.max().item()


def prep_parity(sp, bl, dev, errs):
    """Phase 2's prep kernel (prep.transition_prep) against its plain
    version (prep.transition_prep_plain, the torch ops it replaced) on the
    same card operands: the flagship's trees at two draws of branch
    lengths each (2 BATCH rows, as the benchmark's stream mix), at
    GTR+Gamma4, at GTR+Gamma PREP_WIDE_C, and at Gamma shape
    PREP_OLD_SHAPE with every tree's first branches PREP_OLD_BRANCHES
    long; every entry of P and dP within one float32 ulp of the torch
    ops' or within PREP_TINY absolute, row N the identity and zero.  Fills
    errs; returns phase 4's work and calls at GTR+Gamma4 (bound by the
    bytes written, 128 a matrix, and the branch lengths read: its float64
    arithmetic, about 300 operations a matrix, takes under 1 us at the
    FP64 units' rate)."""
    draw = torch.exp(0.1 * torch.randn(
        bl.shape, device=dev, generator=torch.Generator(device=dev).manual_seed(
            SEED)))
    two = torch.cat([bl, bl * draw])
    old = two.clone()
    old[:, :len(PREP_OLD_BRANCHES)] = torch.tensor(PREP_OLD_BRANCHES,
                                                   device=dev)
    old_params = dict(PARAMS, site_model_parameters=np.array(
        [PREP_OLD_SHAPE]))
    worst = [0.0, 0.0]
    for label, C, p, b in (("GTR+Gamma4", 4, PARAMS, two),
                           (f"GTR+Gamma{PREP_WIDE_C}", PREP_WIDE_C, PARAMS,
                            two),
                           (f"GTR+Gamma4 at shape {PREP_OLD_SHAPE:g}, "
                            f"branches {PREP_OLD_BRANCHES}", 4, old_params,
                            old)):
        eng = TreeLikelihoodEngine(sp, category_model(C), device=dev,
                                   dtype=PRODUCT_DTYPE)
        eig, rates, _, clock = eng._model_ingredients(
            params_from_numpy(p, dev, PRODUCT_DTYPE), b.shape[0])
        before = prep.transition_prep.launches
        P, dP = prep.transition_prep(eig, rates, clock, b)
        P0, dP0 = prep.transition_prep_plain(eig, rates, clock, b)
        torch.cuda.synchronize()
        check(prep.transition_prep.launches == before + 1,
              f"transition_prep launched once at {label}")
        N = b.shape[1]
        misses = [ulp_misses(P, P0), ulp_misses(dP, dP0)]
        eye = torch.eye(4, device=dev).expand(b.shape[0], C, 4, 4)
        print(f"# phase 2: transition_prep at {label}, {b.shape[0]} trees: "
              f"P {misses[0][0]} and dP {misses[1][0]} entries past one "
              f"float32 ulp and {PREP_TINY:g} of the torch ops', max abs "
              f"diff {misses[0][1]:.3e} / {misses[1][1]:.3e}")
        check(misses[0][0] == 0 and misses[1][0] == 0,
              f"transition_prep within one ulp of the torch ops at {label}")
        check(bool(torch.equal(P[:, N], eye)) and not bool(dP[:, N].any()),
              f"transition_prep's row N at {label}")
        worst = [max(worst[0], norm_err(P, P0), norm_err(dP, dP0)),
                 max(worst[1], misses[0][1], misses[1][1])]
        if C == 4 and p is PARAMS:
            ops = (eig, rates, clock, b)
            work = {"transition_prep": (0, nbytes(P, dP, b), None)}
        del eng, P, dP, P0, dP0
    errs["transition_prep"] = tuple(worst)
    calls = {"transition_prep": (lambda: prep.transition_prep_plain(*ops),
                                 lambda: prep.transition_prep(*ops))}
    return work, calls


def category_parity(dev, errs):
    """Phase 2 at CATEGORY_COUNTS rate categories: both paired kernels
    through their wrappers against the float64 plain version on the same
    operands, within BOUND, on the flagship (the on-chip bodies), on the
    flagship with every branch CATEGORY_EDGE_LENGTH long, and on the large
    path's trees (the global bodies: the lane layout in device memory);
    each case launching the body its plan names.  Fills errs for the
    JSON line's entries at CATEGORY_PATH_C."""
    params = params_from_numpy(PARAMS, dev, PRODUCT_DTYPE)
    trees, sp, _ = flagship()
    ltrees, lsp, _ = large_trees()
    bodies = (paired.paired_ll_onchip, paired.paired_grad_onchip,
              paired.paired_ll_global, paired.paired_grad_global)
    for C in CATEGORY_COUNTS:
        cases = (("flagship", trees, sp, None), ("flagship, branches "
                 f"{CATEGORY_EDGE_LENGTH:g}", trees, sp, CATEGORY_EDGE_LENGTH),
                 ("large", ltrees, lsp, None))
        engines = {}  # one a tree set, with rows 3-6's tapes, built once
        for label, tr, s, edge in cases:
            if id(tr) not in engines:
                new = TreeLikelihoodEngine(s, category_model(C), device=dev,
                                           dtype=PRODUCT_DTYPE)
                engines[id(tr)] = (new, rows_tapes(new, tr))
            eng, tapes = engines[id(tr)]
            enc = eng.encode(tr)
            bl = eng.branch_length_matrix(tr, enc)
            if edge is not None:
                bl = torch.where(bl > 0, torch.full_like(bl, edge), bl)
            ll_ops, grad_ops, on = paired_operands(eng, tr, params, bl)
            M, N1 = ll_ops[0].shape[1], ll_ops[3].shape[1]
            plans = (paired.onchip_plan("ll", on.ll_rows, M, N1, C),
                     paired.onchip_plan("grad", on.grad_rows, M, N1, C))
            onchip = label != "large"
            check(all((p is not None) == onchip for p in plans),
                  f"C={C} {label}: the plans name the "
                  + ("on-chip" if onchip else "global") + " bodies")
            before = [f.launches for f in bodies]
            ll_k = paired.paired_log_likelihoods(*ll_ops, onchip=on)
            ll_g, g_k = paired.paired_ll_and_gradients(*grad_ops, onchip=on)
            torch.cuda.synchronize()
            ran = [f.launches - n for f, n in zip(bodies, before)]
            check(ran == ([1, 1, 0, 0] if onchip else [0, 0, 1, 1]),
                  f"C={C} {label}: the wrappers launched the planned bodies")
            ll_p, g_p = plain64(grad_ops)
            e = (rel_err(ll_k, ll_p), rel_err(ll_g, ll_p), norm_err(g_k, g_p))
            finite = bool(torch.isfinite(ll_k).all()
                          and torch.isfinite(g_k).all())
            print(f"# phase 2: paired kernels at C={C} ({paired.lanes(C)} lanes), "
                  f"{label} ({len(tr)} trees x {eng.pattern_pad} patterns, "
                  f"{enc.num_taxa} taxa; "
                  + ("on-chip bodies, plans " + ", ".join(
                      f"{p.cols} patterns a block{' ring' if p.ring else ''}"
                      for p in plans) if onchip else "global bodies")
                  + f"): LL rel err {e[0]:.3e}, grad kernel's LL {e[1]:.3e}, "
                  f"grad max-abs/max|g| {e[2]:.3e} (bound {BOUND:g}, plain "
                  "version in float64 on the same operands)")
            check(finite and max(e) <= BOUND,
                  f"C={C} {label}: the paired kernels within {BOUND:g}")
            if C == CATEGORY_PATH_C and edge is None and onchip:
                errs["paired_ll_onchip@C16"] = (
                    e[0], (ll_k.double() - ll_p).abs().max().item())
                errs["paired_grad_onchip@C16"] = (
                    e[2], (g_k.double() - g_p).abs().max().item())
            del ll_ops, grad_ops, on, ll_p, g_p
            torch.cuda.empty_cache()
            flagship_bl = edge is None and onchip
            category_rows_parity(C, label, eng, tr, params, bl, tapes,
                                 flagship_bl, errs if flagship_bl
                                 and C == CATEGORY_PATH_C else None)
            del eng, tapes
            torch.cuda.empty_cache()
        del engines
        torch.cuda.empty_cache()


# The chunked and per-node kernels' launchers (rows 3-6): the on-chip and
# global LL bodies, and the own on-chip, paired on-chip and global grad
# bodies, of each family
ROWS_BODIES = (chunked.chunked_ll_onchip, chunked.chunked_ll_global,
               chunked.chunked_grad_onchip, chunked.chunked_grad_paired,
               chunked.chunked_grad_global,
               pernode.pernode_ll_onchip, pernode.pernode_ll_global,
               pernode.pernode_grad_onchip, pernode.pernode_grad_paired,
               pernode.pernode_grad_global)


def rows_tapes(eng, trees):
    """The chunked and per-node kernels' tapes of `trees` on `eng`'s
    device: (the chunked tapes with the edge mask, their OnchipTape, the
    per-node tapes, their LLTape, their OnchipTape)."""
    enc = eng.encode(trees)
    dev = eng.device
    chunked_tapes = eng._chunked_tapes(enc)
    dst, tip = chunked_tapes[:2]
    T, N = enc.num_taxa, enc.num_slots
    return (chunked_tapes,
            chunked.onchip_tape(dst.cpu().numpy(), tip.cpu().numpy(), dev),
            tuple(torch.as_tensor(x, dtype=torch.int32, device=dev)
                  for x in (enc.post_ops, enc.pre_ops, enc.root)),
            pernode.ll_tape(enc.post_ops, enc.root, T, N, dev),
            pernode.onchip_tape(enc.post_ops, enc.pre_ops, enc.root, T, N,
                                dev))


def rows_operands(eng, trees, params, bl=None, tapes=None):
    """The chunked and per-node kernels' operands on `eng`'s tapes
    (`tapes`, rows_tapes' result, where given) at its branch lengths or
    `bl` (dP from prep.prepare_inputs_grad, as on their routes): (chunked
    LL+gradient operands, its OnchipTape, per-node LL+gradient operands,
    its LLTape, its OnchipTape)."""
    enc = eng.encode(trees)
    bl = eng.branch_length_matrix(trees, enc) if bl is None else bl
    eig, rates, props, clock = eng._model_ingredients(params, len(trees))
    pi, prop = prep.kernel_model(eig, props)
    P, dP = prep.prepare_inputs_grad(eig, rates, clock, bl)
    (dst, tip, e, row, mask), con, (post, pre, root), pll, pon = (
        tapes or rows_tapes(eng, trees))
    tips, w = eng._kernel_tips, eng._kernel_weights
    return ((dst, tip, e, row, mask, P, dP, tips, pi, prop, w), con,
            (post, pre, root, mask, P, dP, tips, pi, prop, w), pll, pon)


def rows_plain64(c_ops, p_ops, step=100):
    """The float64 plain versions of the chunked and per-node LL+gradient
    kernels on the float32 operands, `step` trees at a time (`step`
    bounds their float64 scratch: every slot's partial, and the per-node
    version's adjoints, of those trees): ((ll, grads) chunked, (ll,
    grads) per-node)."""
    out = []
    for plain, ops, ints in (
            (chunked.chunked_ll_and_gradients_ref, c_ops, 4),
            (pernode.pernode_ll_and_gradients_ref, p_ops, 3)):
        parts = [plain(*[x[i:i + step] for x in ops[:ints]],
                       ops[ints][i:i + step].double(),
                       ops[ints + 1][i:i + step].double(),
                       ops[ints + 2][i:i + step].double(),
                       *[x.double() for x in ops[ints + 3:]])
                 for i in range(0, ops[0].shape[0], step)]
        out.append((torch.cat([q[0] for q in parts]),
                    torch.cat([q[1] for q in parts])))
    return out


def rows_bodies(c_ops, con, p_ops, pll, pon):
    """Rows 3-6's bodies: [(row name, family, wrapper call, [(launcher,
    the plan its wrapper reads or True, the plan at one warp or True,
    call(plan))])], each call -> (ll, grads or None).  A wrapper takes the
    first body whose plan is not None (True: the global body)."""
    dst, tip, e, row, mask, P, dP, tips, pi, prop, w = c_ops
    post, pre, root = p_ops[:3]
    N1, C = P.shape[1], P.shape[2]
    MW, M = dst.shape[1], post.shape[1]
    pt = pon.paired
    cfin = lambda rows: chunked.finish_rows(*rows, row, mask, w)
    pfin = lambda rows: pernode.finish_rows(*rows, mask, w)
    by_node = lambda rows: paired.finish_rows(*rows, mask, w)
    return [
        ("chunked LL", "chunked", lambda: (chunked.chunked_log_likelihoods(
            dst, tip, e, P, tips, pi, prop, w, onchip=con), None), [
            (chunked.chunked_ll_onchip, chunked.ll_plan(con.ll_rows, MW, N1, C),
             paired.onchip_plan("ll", con.ll_rows, MW, N1, C, ring=True),
             lambda p: (chunked.chunked_ll_onchip(
                 dst, con, e, P, tips, pi, prop, p) @ w, None)),
            (chunked.chunked_ll_global, True, True,
             lambda p: (chunked.chunked_ll_global(
                 dst, tip, e, P, tips, pi, prop, child=con.child) @ w,
                 None))]),
        ("chunked grad", "chunked", lambda: chunked.chunked_ll_and_gradients(
            *c_ops, onchip=con), [
            (chunked.chunked_grad_onchip,
             chunked.onchip_plan(con.grad_rows, MW, N1, C),
             chunked.onchip_plan(con.grad_rows, MW, N1, C, least=1),
             lambda p: cfin(chunked.chunked_grad_onchip(
                 dst, con, e, P, dP, tips, pi, prop, w, p))),
            (chunked.chunked_grad_paired,
             chunked.paired_plan(con.grad_rows, MW, N1, C),
             paired.onchip_plan("grad", con.grad_rows, MW, N1, C, ring=True),
             lambda p: by_node(chunked.chunked_grad_paired(
                 dst, con, e, row, P, dP, tips, pi, prop, w, p))),
            (chunked.chunked_grad_global, True, True,
             lambda p: cfin(chunked.chunked_grad_global(
                 dst, tip, e, P, dP, tips, pi, prop, w, child=con.child)))]),
        ("pernode LL", "pernode", lambda: (pernode.pernode_log_likelihoods(
            post, root, P, tips, pi, prop, w, onchip=pll), None), [
            (pernode.pernode_ll_onchip,
             paired.onchip_plan("ll", pll.ll_rows, M, N1, C),
             paired.onchip_plan("ll", pll.ll_rows, M, N1, C, ring=True),
             lambda p: (pernode.pernode_ll_onchip(
                 pll, P, tips, pi, prop, p) @ w, None)),
            (pernode.pernode_ll_global, True, True,
             lambda p: (pernode.pernode_ll_global(
                 post, root, P, tips, pi, prop) @ w, None))]),
        ("pernode grad", "pernode", lambda: pernode.pernode_ll_and_gradients(
            *p_ops, onchip=pon), [
            (pernode.pernode_grad_onchip,
             pernode.onchip_plan(pon.rows, pon.ints, N1, C),
             pernode.onchip_plan(pon.rows, pon.ints, N1, C, least=1),
             lambda p: pfin(pernode.pernode_grad_onchip(
                 pon, root, P, dP, tips, pi, prop, w, p))),
            (pernode.pernode_grad_paired, pernode.paired_plan(pt, N1, C),
             paired.onchip_plan("grad", pt.onchip.grad_rows,
                                pt.post_dst.shape[1], N1, C, ring=True),
             lambda p: by_node(pernode.pernode_grad_paired(
                 pt, P, dP, tips, pi, prop, w, p))),
            (pernode.pernode_grad_global, True, True,
             lambda p: pfin(pernode.pernode_grad_global(
                 post, pre, root, P, dP, tips, pi, prop, w)))])]


BODY_NAMES = {chunked.chunked_ll_onchip: "on-chip",
              chunked.chunked_ll_global: "global",
              chunked.chunked_grad_onchip: "on-chip",
              chunked.chunked_grad_paired: "paired on-chip",
              chunked.chunked_grad_global: "global",
              pernode.pernode_ll_onchip: "on-chip",
              pernode.pernode_ll_global: "global",
              pernode.pernode_grad_onchip: "on-chip",
              pernode.pernode_grad_paired: "paired on-chip",
              pernode.pernode_grad_global: "global"}


def rows_runs(c_ops, con, p_ops, pll, pon, forced):
    """([(label, call -> (ll, grads or None), family, launches in
    ROWS_BODIES' order)], [(row name, launcher, plan) of each wrapper's
    route]): the four wrappers, each expected to launch the body its route
    names (the first of rows_bodies' with a plan); with `forced` also every
    other body of each row through its launcher (an on-chip one at one
    warp, where one fits)."""
    hot = lambda f: [int(g is f) for g in ROWS_BODIES]
    runs, routes = [], []
    for name, family, wrapper, bodies in rows_bodies(c_ops, con, p_ops, pll,
                                                     pon):
        taken = next(b for b in bodies if b[1] is not None)
        routes.append((name, taken[0], taken[1]))
        runs.append((f"{name} wrapper", wrapper, family, hot(taken[0])))
        if forced:
            runs += [(f"{name} {BODY_NAMES[f]} body", partial(call, least),
                      family, hot(f))
                     for f, _, least, call in bodies
                     if f is not taken[0] and least is not None]
    return runs, routes


def route_line(routes):
    """The wrappers' routes as phase 2-4's lines name them."""
    return ", ".join(
        f"{name} {BODY_NAMES[f]}" + ("" if plan is True else
                                      f" ({plan.cols * plan.lanes
                                          * plan.op_lanes // 32} "
                                      f"warps{', ring' if plan.ring else ''}"
                                      + (f", K={plan.categories_per_lane}"
                                         if plan.categories_per_lane > 1
                                         else "") + ")")
        for name, f, plan in routes)


def category_rows_parity(C, label, eng, trees, params, bl, tapes, forced,
                         errs):
    """Rows 3-6 (the chunked and per-node kernels) at C categories on one
    of category_parity's cases: each wrapper launches the body its route
    names, and with `forced` (the flagship at its own branch lengths) also
    every other body through its launcher; every one within BOUND of the
    float64 plain version on the same operands.  Fills `errs`, where
    given, for the JSON line's rows 3-6 entries at CATEGORY_PATH_C."""
    c_ops, con, p_ops, pll, pon = rows_operands(eng, trees, params, bl,
                                                tapes)
    refs = dict(zip(("chunked", "pernode"), rows_plain64(c_ops, p_ops)))
    runs, routes = rows_runs(c_ops, con, p_ops, pll, pon, forced)
    parts = []
    for name, call, family, want in runs:
        before = [f.launches for f in ROWS_BODIES]
        ll_k, g_k = call()
        torch.cuda.synchronize()
        ran = [f.launches - n for f, n in zip(ROWS_BODIES, before)]
        check(ran == want, f"C={C} {label}: {name} launched {want}, "
              f"not {ran}")
        ll_p, g_p = refs[family]
        e = [rel_err(ll_k, ll_p)] + ([] if g_k is None
                                     else [norm_err(g_k, g_p)])
        finite = bool(torch.isfinite(ll_k).all()) and (
            g_k is None or bool(torch.isfinite(g_k).all()))
        check(finite and max(e) <= BOUND,
              f"C={C} {label}: {name} within {BOUND:g}")
        parts.append(f"{name} " + "/".join(f"{x:.2e}" for x in e))
        if errs is not None and name.endswith("wrapper"):
            key = {"chunked LL": "chunked_ll_onchip",
                   "chunked grad": "chunked_grad_onchip",
                   "pernode LL": "pernode_ll_onchip",
                   "pernode grad": "pernode_grad_onchip"}[
                       name[:-len(" wrapper")]] + "@C16"
            x, ref = (ll_k, ll_p) if g_k is None else (g_k, g_p)
            errs[key] = (e[-1], (x.double() - ref).abs().max().item())
    print(f"# phase 2: chunked and per-node kernels at C={C}, {label}; "
          f"the wrappers take {route_line(routes)}: LL rel err / grad "
          "max-abs/max|g| against the float64 plain version: "
          + "; ".join(parts) + f" (bound {BOUND:g})")


def categories_path(trees, sp, params, params64, dev, against_reference):
    """The categories path (phase 3): the flagship at GTR+Gamma
    CATEGORY_PATH_C on the engine's auto route (before PR 16 a model past
    8 categories took the scan tape): log_likelihoods,
    ll_and_branch_gradients and CATEGORY_SWEEP calls over scaled branch
    lengths; the same calls on its chunked route (kernel="chunked", whose
    wrappers raised past 8 categories before PR 17); and the per-node
    functions on the same trees and branch lengths.  Each against the
    float64 engine on the scan tape.  Returns (the engine, its launch
    counts)."""
    model = category_model(CATEGORY_PATH_C)
    eng = TreeLikelihoodEngine(sp, model, device=dev, dtype=PRODUCT_DTYPE)
    check(eng._route(True) == "paired",
          f"auto takes the paired kernels at C={CATEGORY_PATH_C}")
    ref = TreeLikelihoodEngine(sp, model, device=dev, dtype=torch.float64)
    ref.kernel = "scan"
    enc = eng.encode(trees)
    bl = eng.branch_length_matrix(trees, enc)
    scales = [1.0 + 0.001 * k for k in range(1, CATEGORY_SWEEP + 1)]
    ref_fn = ref.branch_eval_fn(trees, params64)
    refs = [ref.ll_and_branch_gradients(trees, params64)] + [
        ref_fn(bl.double() * f) for f in scales]
    del ref, ref_fn
    torch.cuda.empty_cache()
    # The per-node functions' operands and tapes, made before the counts
    # are reset.
    eig, rates, props, clock = eng._model_ingredients(params, len(trees))
    pi, prop = prep.kernel_model(eig, props)
    post, pre, root = (torch.as_tensor(x, dtype=torch.int32, device=dev)
                       for x in (enc.post_ops, enc.pre_ops, enc.root))
    mask = torch.as_tensor(enc.edge_mask, dtype=torch.float32, device=dev)
    pll = pernode.ll_tape(enc.post_ops, enc.root, enc.num_taxa,
                          enc.num_slots, dev)
    pon = pernode.onchip_tape(enc.post_ops, enc.pre_ops, enc.root,
                              enc.num_taxa, enc.num_slots, dev)
    tips, w = eng._kernel_tips, eng._kernel_weights
    reset_launches()
    ll = eng.log_likelihoods(trees, params)
    pairs = [eng.ll_and_branch_gradients(trees, params)]
    fn = eng.branch_eval_fn(trees, params)
    pairs += [fn(bl * f) for f in scales]
    eng.kernel = "chunked"
    ll_c = eng.log_likelihoods(trees, params)
    pairs_c = [eng.ll_and_branch_gradients(trees, params)]
    fn = eng.branch_eval_fn(trees, params)
    pairs_c += [fn(bl * f) for f in scales]
    eng.kernel = "auto"
    P, _ = prep.prepare_inputs_grad(eig, rates, clock, bl)
    ll_p = pernode.pernode_log_likelihoods(post, root, P, tips, pi, prop, w,
                                           onchip=pll)
    pairs_p = []
    for f in [1.0] + scales:
        Pk, dPk = prep.prepare_inputs_grad(eig, rates, clock, bl * f)
        pairs_p.append(pernode.pernode_ll_and_gradients(
            post, pre, root, mask, Pk, dPk, tips, pi, prop, w, onchip=pon))
    torch.cuda.synchronize()
    launches = read_launches("categories")
    against_reference("categories", [ll], pairs, refs)
    against_reference("categories (chunked route)", [ll_c], pairs_c, refs)
    against_reference("categories (per-node functions)", [ll_p], pairs_p,
                      refs)
    return eng, launches


def category_times(eng, trees, card):
    """Phase 4 at CATEGORY_COUNTS categories on the flagship: each paired
    kernel through its wrapper (the on-chip bodies) beside its float32
    plain version and its bound, timed in turns (plain, kernel, kernel,
    plain); at CATEGORY_PATH_C also the global bodies on the same
    operands and one LL+gradient call of the auto route beside the scan
    tape's, which auto took before.  `eng` is the categories path's
    engine."""
    params = params_from_numpy(PARAMS, eng.device, PRODUCT_DTYPE)
    sp = eng.site_pattern
    for C in CATEGORY_COUNTS:
        e = eng if C == CATEGORY_PATH_C else TreeLikelihoodEngine(
            sp, category_model(C), device=eng.device, dtype=PRODUCT_DTYPE)
        enc = e.encode(trees)
        ll_ops, grad_ops, on = paired_operands(e, trees, params)
        dst, tip, src, edges, mask, P, dP, tips, pi, prop, w = grad_ops
        fl_ll, fl_grad = tree_flops(enc, sp, e.model, BATCH)
        moved_ll = (nbytes(dst, on.child, on.live_row, edges, P, tips, pi,
                           prop, w) + BATCH * 4)
        moved_grad = (nbytes(dst, on.child, src, edges, P, dP, tips, pi,
                             prop, w, mask) + BATCH * (1 + enc.num_slots) * 4)
        calls = {
            "ll": (lambda: paired.paired_log_likelihoods_ref(*ll_ops),
                   lambda: paired.paired_log_likelihoods(*ll_ops, onchip=on),
                   bound(fl_ll, moved_ll)),
            "grad": (lambda: paired.paired_ll_and_gradients_ref(*grad_ops),
                     lambda: paired.paired_ll_and_gradients(*grad_ops,
                                                            onchip=on),
                     bound(fl_grad, moved_grad))}
        if C == CATEGORY_PATH_C:
            calls["ll global"] = (calls["ll"][0], lambda: paired.paired_ll_global(
                dst, tip, edges, P, tips, pi, prop) @ w, calls["ll"][2])
            calls["grad global"] = (calls["grad"][0], lambda: paired.finish_rows(
                *paired.paired_grad_global(dst, tip, src, edges, P, dP, tips,
                                           pi, prop, w), mask, w),
                calls["grad"][2])
        parts = []
        for name, (plain, kernel, (b_ms, b_by)) in calls.items():
            p1, k1 = cuda_ms(plain, 3), cuda_ms(kernel, 20)
            k2, p2 = cuda_ms(kernel, 20), cuda_ms(plain, 3)
            k, pl = (k1 + k2) / 2, (p1 + p2) / 2
            parts.append(f"{name} {k:.4f} ms (plain {pl:.4f}; bound "
                         f"{b_ms:.4f} by {b_by}, {100 * b_ms / k:.1f}% of it)")
        line = "; ".join(parts)
        if C == CATEGORY_PATH_C:
            bl = e.branch_length_matrix(trees, enc)
            rates = []
            for kernel, reps in (("auto", 20), ("chunked", 20), ("scan", 3)):
                e.kernel = kernel
                f = e.branch_eval_fn(trees, params)
                ms = cuda_ms(lambda: f(bl), reps)
                rates.append(f"{kernel} {ms:.4f} ms ({BATCH / (ms / 1e3):.1f}"
                             " evals/s)")
            e.kernel = "auto"
            line += ("; one LL+gradient call (branch_eval_fn): "
                     + ", ".join(rates))
        plan = paired.onchip_plan("grad", on.grad_rows, dst.shape[1],
                                  P.shape[1], C)
        print(f"# phase 4: paired kernels at C={C} ({paired.lanes(C)} lanes; "
              f"grad plan {plan.cols} patterns a block"
              f"{', ring' if plan.ring else ', staged'}), flagship "
              f"(float32, {BATCH} trees x {e.pattern_pad} patterns, CUDA "
              f"events): {line}; on {card}")
        del ll_ops, grad_ops, on, calls
        torch.cuda.empty_cache()
        category_rows_times(C, e, trees, params, (fl_ll, fl_grad),
                            BATCH * (1 + enc.num_slots) * 4, card)
        del e
        torch.cuda.empty_cache()


def category_rows_times(C, eng, trees, params, flops, grad_out, card):
    """Phase 4 for rows 3-6 (the chunked and per-node kernels) at C
    categories on the flagship: each wrapper (the body its plan names)
    beside its float32 plain version and its bound (the paired kernels'
    FLOPs, the family's own bytes), in turns (plain, kernel, kernel,
    plain); at CATEGORY_PATH_C also each global body on the same
    operands."""
    c_ops, con, p_ops, pll, pon = rows_operands(eng, trees, params)
    dst, tip, e, row, mask, P, dP, tips, pi, prop, w = c_ops
    post, pre, root = p_ops[:3]
    fl_ll, fl_grad = flops
    f_ll = nbytes(P, tips, pi, prop, w) + BATCH * 4
    f_grad = nbytes(P, dP, tips, pi, prop, w, mask) + grad_out
    calls = {
        "chunked ll": (
            lambda: chunked.chunked_log_likelihoods_ref(
                dst, tip, e, P, tips, pi, prop, w),
            lambda: chunked.chunked_log_likelihoods(
                dst, tip, e, P, tips, pi, prop, w, onchip=con),
            bound(fl_ll, nbytes(dst, con.child, con.live_row, e) + f_ll)),
        "chunked grad": (
            lambda: chunked.chunked_ll_and_gradients_ref(*c_ops),
            lambda: chunked.chunked_ll_and_gradients(*c_ops, onchip=con),
            bound(fl_grad, nbytes(dst, con.child, e, row) + f_grad)),
        "pernode ll": (
            lambda: pernode.pernode_log_likelihoods_ref(
                post, root, P, tips, pi, prop, w),
            lambda: pernode.pernode_log_likelihoods(
                post, root, P, tips, pi, prop, w, onchip=pll),
            bound(fl_ll, nbytes(pll.post_dst, pll.child, pll.live_row,
                                pll.post_e) + f_ll)),
        "pernode grad": (
            lambda: pernode.pernode_ll_and_gradients_ref(*p_ops),
            lambda: pernode.pernode_ll_and_gradients(*p_ops, onchip=pon),
            bound(fl_grad, nbytes(pon.post, pon.groups, pon.zero, root)
                  + f_grad))}
    if C == CATEGORY_PATH_C:
        calls["chunked ll global"] = (calls["chunked ll"][0], lambda: (
            chunked.chunked_ll_global(dst, tip, e, P, tips, pi, prop,
                                      child=con.child) @ w),
            bound(fl_ll, nbytes(dst, con.child, e) + f_ll))
        calls["chunked grad global"] = (calls["chunked grad"][0], lambda: (
            chunked.finish_rows(*chunked.chunked_grad_global(
                dst, tip, e, P, dP, tips, pi, prop, w, child=con.child),
                row, mask, w)),
            bound(fl_grad, nbytes(dst, con.child, e, row) + f_grad))
        calls["pernode ll global"] = (calls["pernode ll"][0], lambda: (
            pernode.pernode_ll_global(post, root, P, tips, pi, prop) @ w),
            bound(fl_ll, nbytes(post, root) + f_ll))
        calls["pernode grad global"] = (calls["pernode grad"][0], lambda: (
            pernode.finish_rows(*pernode.pernode_grad_global(
                post, pre, root, P, dP, tips, pi, prop, w), mask, w)),
            bound(fl_grad, nbytes(post, pre, root) + f_grad))
    parts = []
    for name, (plain, kernel, (b_ms, b_by)) in calls.items():
        p1, k1 = cuda_ms(plain, 2, warmup=1), cuda_ms(kernel, 10)
        k2, p2 = cuda_ms(kernel, 10), cuda_ms(plain, 2, warmup=1)
        k, pl = (k1 + k2) / 2, (p1 + p2) / 2
        parts.append(f"{name} {k:.4f} ms (plain {pl:.4f}; bound "
                     f"{b_ms:.4f} by {b_by}, {100 * b_ms / k:.1f}% of it)")
    routes = rows_runs(c_ops, con, p_ops, pll, pon, False)[1]
    print(f"# phase 4: chunked and per-node kernels at C={C} "
          f"({paired.lanes(C)} lanes; the wrappers take {route_line(routes)})"
          f", flagship (float32, {BATCH} trees x {eng.pattern_pad} patterns, "
          "CUDA events): " + "; ".join(parts) + f"; on {card}")


# Rows 4 and 6's grad kernels where their own on-chip bodies get no plan
# at the flagship: phase 4 times every body of them at these counts
PAIRED_ROWS_COUNTS = (17, 32)


def paired_rows_times(trees, sp, params, dev, card):
    """Phase 4 for rows 4 and 6 at PAIRED_ROWS_COUNTS on the flagship,
    where their wrappers take the paired grad body on their tapes: every
    body of each (its own on-chip body at one warp, the paired one as
    the wrapper takes it, the lane global body) beside the float32 plain
    version and the bound (the paired kernels' FLOPs, the family's own
    bytes), in turns (plain, bodies, bodies backward, plain)."""
    for C in PAIRED_ROWS_COUNTS:
        eng = TreeLikelihoodEngine(sp, category_model(C), device=dev,
                                   dtype=PRODUCT_DTYPE)
        enc = eng.encode(trees)
        fl_grad = tree_flops(enc, sp, eng.model, BATCH)[1]
        c_ops, con, p_ops, pll, pon = rows_operands(eng, trees, params)
        dst, tip, e, row, mask, P, dP, tips, pi, prop, w = c_ops
        post, pre, root = p_ops[:3]
        f_grad = (nbytes(P, dP, tips, pi, prop, w, mask)
                  + BATCH * (1 + enc.num_slots) * 4)
        moved = {chunked.chunked_grad_onchip: nbytes(dst, con.child, e, row),
                 chunked.chunked_grad_paired: nbytes(dst, con.child, e, row)
                 + dst.numel() * 8,
                 chunked.chunked_grad_global: nbytes(dst, tip, e, row),
                 pernode.pernode_grad_onchip: nbytes(pon.post, pon.groups,
                                                     pon.zero, root),
                 pernode.pernode_grad_paired: nbytes(
                     pon.paired.post_dst, pon.paired.onchip.child,
                     pon.paired.post_src, pon.paired.post_e),
                 pernode.pernode_grad_global: nbytes(post, pre, root)}
        parts, routes = [], []
        for name, family, wrapper, bodies in rows_bodies(
                c_ops, con, p_ops, pll, pon)[1::2]:
            taken = next(b for b in bodies if b[1] is not None)
            routes.append((name, taken[0], taken[1]))
            plain = (partial(chunked.chunked_ll_and_gradients_ref, *c_ops)
                     if family == "chunked" else
                     partial(pernode.pernode_ll_and_gradients_ref, *p_ops))
            calls = {f"{name} {BODY_NAMES[f]}": (partial(call, least), f)
                     for f, _, least, call in bodies if least is not None}
            p1 = cuda_ms(plain, 2, warmup=1)
            ms = {k: [cuda_ms(c, 10)] for k, (c, _) in calls.items()}
            for k in reversed(list(calls)):
                ms[k].append(cuda_ms(calls[k][0], 10))
            pl = (p1 + cuda_ms(plain, 2, warmup=1)) / 2
            for k, (_, f) in calls.items():
                t = sum(ms[k]) / 2
                b_ms, b_by = bound(fl_grad, moved[f] + f_grad)
                parts.append(f"{k} {t:.4f} ms (bound {b_ms:.4f} by {b_by}, "
                             f"{100 * b_ms / t:.1f}%)")
            parts.append(f"{name} plain {pl:.4f} ms")
        print(f"# phase 4: rows 4 and 6 at C={C}, every body (the wrappers "
              f"take {route_line(routes)}), flagship (float32, {BATCH} trees "
              f"x {eng.pattern_pad} patterns, CUDA events): "
              + "; ".join(parts) + f"; on {card}")
        del eng, c_ops, con, p_ops, pll, pon
        torch.cuda.empty_cache()


def topology_set_ms(sp, model, trees, reps):
    """Host milliseconds the engine spends on a set of topologies it has
    not seen, before its first launch: (encoding, the paired tapes with
    the on-chip tape on the card, the on-chip tape alone), medians over
    `reps` fresh engines."""
    runs = []
    for _ in range(reps):
        e = TreeLikelihoodEngine(sp, model)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        enc = e.encode(trees)
        t1 = time.perf_counter()
        e._paired_tapes(enc)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        pe = paired.build_paired_encoding(enc)
        t3 = time.perf_counter()
        paired.onchip_tape(pe.post_dst, pe.tip_slot, e.device,
                           post_src=pe.post_src, post_e=pe.post_e,
                           edges=enc.num_slots + 1)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        runs.append(((t1 - t0) * 1e3, (t2 - t1) * 1e3, (t4 - t3) * 1e3))
    return [float(np.median(c)) for c in zip(*runs)]


def tree_flops(enc, sp, model, batch):
    """(LL, LL+gradient) FLOPs of one call over `batch` trees, counted as
    bench.py:135-150 counts them: the algorithm's work over the true
    patterns, independent of the kernel."""
    S, C = sp.pattern_count, model.category_count
    CA = 4 * C
    E = int(np.asarray(enc.edge_mask).sum(axis=1).mean())
    n_internal = max(enc.num_slots - sp.num_taxa, 1)
    evolve = 2 * 16 * C * S
    fl_ll = E * evolve + n_internal * CA * S + 2 * CA * S
    fl_grad = fl_ll + E * (2 * evolve + 3 * CA * S)
    return fl_ll * batch, fl_grad * batch


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(flops, moved, peak=PEAK_FLOPS):
    """(ms, "operations" or "bytes"): the least time the card could take,
    at `peak` FLOP/s (PEAK_FLOPS: float32 FMAs) and PEAK_BYTES."""
    t_ops, t_bytes = flops / peak * 1e3, moved / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def kernel_bound(flops, moved, library=None, shared_ms=0.0, *,
                 peak=PEAK_FLOPS):
    """bound() of a phase-4 work entry at the kernel's `peak`, or its
    shared-memory term (ms of the bytes it must move through shared
    memory, pipe_cell's scratch) where that is larger."""
    return max(bound(flops, moved, peak), (shared_ms, "bytes"))


def bound_of(name, work):
    """kernel_bound of kernel `name`'s work entry at its peak (KERNELS'
    `peak`: 3xTF32 for the A=64 kernels, else float32 FMAs)."""
    return kernel_bound(*work[name],
                        peak=KERNELS[name].get("peak", PEAK_FLOPS))


# An instruction line of cuobjdump -sass: its address, a predicate, then
# the opcode
SASS_LINE = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)")


def sass_mix(so, names=TENSOR_KERNELS):
    """{kernel: Counter of its SASS opcodes} for the kernels of the library
    `so` whose mangled names hold one of `names`, read with cuobjdump."""
    cuobjdump = os.path.join(os.path.dirname(_kernels._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(so)], check=True,
                          capture_output=True, text=True).stdout
    mix, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = next((n for n in names if n in m.group(1)), None)
            if fn:
                mix[fn] = collections.Counter()
            continue
        m = SASS_LINE.search(line)
        if fn and m:
            mix[fn][m.group(1)] += 1
    return mix


def reset_launches():
    for spec in KERNELS.values():
        spec["wrapper"].launches = 0


def read_launches(path):
    """{kernel: launches} for the kernels of `path`, after checking that
    each kernel the path runs launched and that no other kernel did."""
    counts = {name: spec["wrapper"].launches for name, spec in KERNELS.items()}
    print(f"# phase 3: {path} path launches {counts}")
    for name, spec in KERNELS.items():
        if spec["path"] == path or path in spec.get("also", ()):
            check(counts[name] > 0, f"{name} launched in the {path} path")
        else:
            check(counts[name] == 0, f"{name} did not launch in the {path} "
                  "path")
    return {n: c for n, c in counts.items() if KERNELS[n]["path"] == path}


# What phase 4 times each probe at (the flagship's operands for
# variant_grad).
PIPE_TIMED = "paired-like"
CHAIN_R = 20
# phase 4 times them, and their library call, by graph_ms
GRAPH_TIMED = ("pipe_cell", "stream_sum_4d", "stream_sum_3d", "static_chain",
               "chunk_variant", "transition_prep")
LAB_SHAPES = {
    "transition_prep": f"GTR+Gamma4, float64 ingredients to float32 P and "
                       f"dP, {2 * BATCH} trees x 53 edges",
    "variant_grad": f"unroll, float32, {BATCH} trees x 1024 patterns",
    "paired_grad_ckpt": f"float32, {BATCH} trees of {CKPT_TAXA} taxa x "
                        "1024 patterns",
    "pipe_cell": f"{PIPE_TIMED}, {CELLS} cells",
    "stream_sum_4d": f"{CELLS} cells of 32 x 256 x 128 bf16",
    "stream_sum_3d": f"{CELLS} cells of 8192 x 128 bf16",
    "static_chain": f"dynamic, R={CHAIN_R}, 52 ops x 1024 columns",
    "chunk_variant": f"v0 (the shipping body), float32, {BATCH} trees x "
                     "1024 patterns",
    **{name + suffix: (
        f"MG94 {model}, float32, {CODON_BATCH} trees x "
        f"{pruning.pad_patterns(_synthetic.DS1_DISTINCT_CODON_COLUMNS)} "
        f"patterns ({_synthetic.DS1_DISTINCT_CODON_COLUMNS} true), "
        f"{_synthetic.DS1_TAXA} taxa")
       for suffix, model in (("", "C=1"),
                             ("@C16", f"+Gamma{CODON_CATEGORY_C}"))
       for name in ("paired_ll_a64", "paired_grad_a64")},
    **{f"{name}@C{WIDE_CODON_C}": (
        f"MG94 +Gamma{WIDE_CODON_C}, float32, the wide path's first "
        f"{WIDE_CODON_TREES} trees x "
        f"{pruning.pad_patterns(_synthetic.DS1_DISTINCT_CODON_COLUMNS)} "
        f"patterns, {_synthetic.DS1_TAXA} taxa")
       for name in ("paired_ll_a64", "paired_grad_a64")},
    **{f"{row}@C{WIDE_C}": f"GTR+Gamma{WIDE_C}, float32, {BATCH} trees x "
                           "1024 patterns"
       for row in WIDE_ROWS},
}


def pipe_plan_line(exp):
    plan = perf_pipe_lab.pipe_plan(*exp[:2])
    return (f"T={plan.tile} columns a block, {16 * plan.tile} threads, "
            f"{plan.smem} B of shared memory, TMA boxes of {plan.stage_rows} "
            "rows")


def probe_parity(ops, dev, errs):
    """Phase 2 for the perf lab's four kernels: each against its plain
    version on the inputs of the perflab path.  Fills errs; returns phase
    4's {kernel: (call of the plain version, call of the kernel)}, the
    plain outputs of the filled pipe experiments, and {kernel: (FLOPs,
    bytes, call of the PyTorch function or None)} of the timed probes but
    variant_grad."""
    ops64 = {k: v.double() if v.is_floating_point() else v
             for k, v in ops.items()}
    lab_on = perf_lab.onchip_of(ops)
    worst = (0.0, 0.0)
    for name, knobs in perf_lab.VARIANTS.items():
        ll_k, g_k = perf_lab.variant_ll_and_gradients(**ops, **knobs,
                                                      onchip=lab_on)
        torch.cuda.synchronize()
        ll_p, g_p = perf_lab.variant_ll_and_gradients_ref(**ops64, **knobs)
        if knobs["nodot"]:  # not a likelihood: -inf where tips disagree
            fin = torch.isfinite(ll_p)
            check(torch.equal(torch.isfinite(ll_k), fin)
                  and torch.equal(ll_k[~fin].double(), ll_p[~fin]),
                  "variant_grad nodot: the same non-finite log likelihoods")
            ll_err = rel_err(ll_k[fin], ll_p[fin]) if fin.any() else 0.0
            g_err = ((g_k.double() - g_p).abs().max()
                     / max(g_p.abs().max().item(), 1.0)).item()
        else:
            ll_err, g_err = rel_err(ll_k, ll_p), norm_err(g_k, g_p)
            worst = max(worst, (g_err, (g_k.double() - g_p).abs().max().item()))
        print(f"# phase 2: variant_grad {name}: LL rel err {ll_err:.3e}, grad "
              f"max-abs/max|g| {g_err:.3e} (bound {BOUND:g}, plain version in "
              f"float64)")
        check(ll_err <= BOUND and g_err <= BOUND, f"variant_grad {name} parity")
    errs["variant_grad"] = worst

    # The pipe cell on the script's ones block (phase 3 holds the perflab
    # path to these outputs) and on a block of small integers, which tells
    # apart each cell's rows.
    plain_outs = {}
    worst = 0.0
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for name, (rows, scratch_rows, init, loops, stores) in (
            perf_pipe_lab.EXPS.items()):
        if not init:  # no defined output on either side
            continue
        idx, big = perf_pipe_lab.pipe_inputs(rows, scratch_rows, CELLS, dev)
        ints = torch.randint(0, 8, tuple(big.shape), generator=gen,
                             dtype=torch.uint8, device=dev).to(torch.bfloat16)
        kw = dict(scratch_rows=scratch_rows, init=init, loops=loops,
                  stores=stores)
        for block, what in ((big, "ones"), (ints, "integers in [0, 8)")):
            out = perf_pipe_lab.pipe_cell(idx, block, **kw)
            torch.cuda.synchronize()
            want = perf_pipe_lab.pipe_cell_ref(idx, block, **kw)
            plain_outs.setdefault(name, want)
            err = (out - want).abs().max().item()
            worst = max(worst, err)
            print(f"# phase 2: pipe_cell {name}, block of {what}: max abs err "
                  f"{err:g} (exact)")
            check(err == 0, f"pipe_cell {name} parity on a block of {what}")
        del ints
    errs["pipe_cell"] = (worst, worst)

    _, nslices, rows, cols = perf_pipe_lab.DMA4D
    block = torch.as_tensor(np.random.default_rng(SEED).integers(
        0, 8, (CELLS, nslices, rows, cols)),
        dtype=torch.bfloat16, device=dev)
    want = perf_pipe_lab.stream_sum_ref(block)
    # A random bf16 block against its float64 sums, within n u sum|x|:
    # the worst case of n float32 additions in any order (u = 2^-24, n the
    # groups a sum adds).
    rnd = torch.randn((CELLS, nslices, rows, cols), generator=gen,
                      device=dev).to(torch.bfloat16)
    groups = nslices * rows // 8
    want64 = rnd.double().reshape(CELLS, -1, 8, cols).sum(dim=1)
    tol = groups * 2.0**-24 * rnd.double().abs().reshape(
        CELLS, -1, 8, cols).sum(dim=1)
    for name, walk in (("stream_sum_4d", lambda x: x),
                       ("stream_sum_3d", lambda x: x.reshape(
                           CELLS, nslices * rows, cols))):
        out = KERNELS[name]["wrapper"](walk(block))
        torch.cuda.synchronize()
        err = (out - want).abs().max().item()
        print(f"# phase 2: {name}: max abs err {err:g} (exact, integers in "
              f"[0, 8))")
        check(err == 0, f"{name} parity")
        out = KERNELS[name]["wrapper"](walk(rnd))
        torch.cuda.synchronize()
        diff = (out.double() - want64).abs()
        errs[name] = (diff.max().item(), diff.max().item())
        print(f"# phase 2: {name}: random bf16 block, max abs err "
              f"{diff.max().item():.3e} against the float64 sums, at most "
              f"{(diff / tol).max().item():.3e} of the bound n u sum|x| "
              f"(n={groups})")
        check(bool((diff <= tol).all()), f"{name} parity on a random block")
    del rnd, want64, tol

    tape, L = perf_static_probe.probe_inputs(dev)
    worst = (0.0, 0.0)
    for dynamic in (True, False):
        ref = perf_static_probe.static_chain_ref(tape, L, dynamic=dynamic,
                                                 R=CHAIN_R)
        for warps in perf_static_probe.LAYOUTS:
            out = perf_static_probe.static_chain(tape, L, dynamic=dynamic,
                                                 R=CHAIN_R, warps=warps)
            torch.cuda.synchronize()
            err = norm_err(out, ref)
            worst = max(worst, (err, (out - ref).abs().max().item()))
            print(f"# phase 2: static_chain dynamic={dynamic} R={CHAIN_R}, "
                  f"{warps} warps a column: max-abs/max|out| {err:.3e} "
                  "(bound 1e-5, float32 plain)")
            check(bool(torch.isfinite(out).all()) and err <= 1e-5,
                  f"static_chain dynamic={dynamic} warps={warps} parity")
    errs["static_chain"] = worst

    exp = perf_pipe_lab.EXPS[PIPE_TIMED]
    idx, big = perf_pipe_lab.pipe_inputs(*exp[:2], CELLS, dev)
    # (device-memory ms, shared-memory ms): the scratch's fill and stores
    # at 128 B a clock an SM
    pipe_terms = perf_pipe_lab.pipe_bound_ms(
        *exp, cells=CELLS,
        sms=torch.cuda.get_device_properties(dev).multi_processor_count,
        clock_mhz=max_sm_clock_mhz())
    print(f"# phase 2: pipe_cell {PIPE_TIMED} plan: {pipe_plan_line(exp)}; "
          f"bound terms: device memory {pipe_terms[0]:.4f} ms, shared "
          f"memory {pipe_terms[1]:.4f} ms")
    pipe_kw = dict(zip(("scratch_rows", "init", "loops", "stores"), exp[1:]))
    pipe_plan = perf_pipe_lab.pipe_plan(*exp[:2])
    pipe_out = torch.empty((CELLS, 8, perf_pipe_lab.S), dtype=torch.float32,
                           device=dev)
    overlap = perf_static_probe.check_chain(tape, L)
    chain_out = torch.empty((8, perf_static_probe.S), dtype=torch.float32,
                            device=dev)
    big3 = block.reshape(CELLS, nslices * rows, cols)
    unroll = perf_lab.VARIANTS["unroll"]
    # What each probe must move and compute (phase 4's bound), and the one
    # PyTorch call that computes a stream sum: the grouped sum in float32.
    out_pipe = CELLS * 8 * perf_pipe_lab.S * 4
    out_sums = CELLS * 8 * cols * 4
    chain_flops = (2 * perf_static_probe.FMAS_PER_OP * perf_static_probe.S
                   * perf_static_probe.M * CHAIN_R)
    sum_outs = [torch.empty((CELLS, 8, cols), dtype=torch.float32,
                            device=dev) for _ in range(4)]
    work = {
        "pipe_cell": (0, nbytes(idx, big) + out_pipe, None, pipe_terms[1]),
        "stream_sum_4d": (CELLS * nslices * rows * cols, nbytes(block)
                          + out_sums, lambda: perf_pipe_lab.torch_stream_sum(
                              block, sum_outs[0])),
        "stream_sum_3d": (CELLS * nslices * rows * cols, nbytes(big3)
                          + out_sums, lambda: perf_pipe_lab.torch_stream_sum(
                              big3, sum_outs[1])),
        "static_chain": (chain_flops,
                         nbytes(tape, L) + 8 * perf_static_probe.S * 4, None),
    }
    # The pipe cell, the stream sums and the chain check their operands
    # once (above) and are timed at their launches into outputs allocated
    # once (graph_ms), torch.sum too.
    return {
        "variant_grad": (
            lambda: perf_lab.variant_ll_and_gradients_ref(**ops, **unroll),
            lambda: perf_lab.variant_ll_and_gradients(**ops, **unroll,
                                                      onchip=lab_on)),
        "pipe_cell": (
            lambda: perf_pipe_lab.pipe_cell_ref(idx, big, **pipe_kw),
            lambda: perf_pipe_lab.launch_pipe_cell(idx, big, pipe_out,
                                                   pipe_plan, **pipe_kw)),
        "stream_sum_4d": (lambda: perf_pipe_lab.stream_sum_ref(block),
                          lambda: perf_pipe_lab.launch_stream_sum(
                              block, sum_outs[2])),
        "stream_sum_3d": (lambda: perf_pipe_lab.stream_sum_ref(big3),
                          lambda: perf_pipe_lab.launch_stream_sum(
                              big3, sum_outs[3])),
        "static_chain": (
            lambda: perf_static_probe.static_chain_ref(tape, L, dynamic=True,
                                                       R=CHAIN_R),
            lambda: perf_static_probe.launch_chain(tape, L, chain_out, True,
                                                   CHAIN_R, overlap)),
    }, plain_outs, work


def run_perflab(ops, dev):
    """The perflab path: the perf lab's entry points, as `python -m
    bito_tpu_torch.perflab lab|pipe|static` runs them, at LAB_REPS
    repetitions.  Returns their results."""
    print("# phase 3: perflab path (python -m bito_tpu_torch.perflab lab, "
          f"pipe, pipe dma4d, static; {LAB_REPS} repetitions each)")
    tape, L = perf_static_probe.probe_inputs(dev)
    return dict(
        lab=perf_lab.run_variants(perf_lab.NAMES, ops, reps=LAB_REPS),
        pipe={name: perf_pipe_lab.run(name, *exp, reps=LAB_REPS, cells=CELLS)
              for name, exp in perf_pipe_lab.EXPS.items()},
        dma4d=perf_pipe_lab.run4d(*perf_pipe_lab.DMA4D, reps=LAB_REPS,
                                  cells=CELLS),
        static=perf_static_probe.slopes(tape, L, reps=LAB_REPS))


def check_perflab(lab, plain_outs):
    """Phase 3's checks of the perflab path's results."""
    _, ll0, g0 = lab["lab"]["base"]
    for name, (ms, ll, g) in lab["lab"].items():
        check(ms > 0, f"perflab {name} was timed")
        if name == "nodot":  # not a likelihood: no finiteness check
            continue
        check(bool(torch.isfinite(ll).all() and torch.isfinite(g).all()),
              f"perflab {name} outputs are finite")
        check(rel_err(ll, ll0) <= BOUND and norm_err(g, g0) <= BOUND,
              f"perflab {name} agrees with base")
    for name, (per_cell, out) in lab["pipe"].items():
        check(per_cell > 0 and out.shape == (CELLS, 8,
                                             perf_pipe_lab.S),
              f"pipe {name} timed, output shape")
        if name in plain_outs:
            check(torch.equal(out, plain_outs[name]),
                  f"pipe {name} equals its plain output")
    (_, out4, _), (_, out3, _) = lab["dma4d"]["4d"], lab["dma4d"]["3d"]
    groups = perf_pipe_lab.DMA4D[1] * perf_pipe_lab.DMA4D[2] // 8
    check(torch.equal(out4, out3) and bool((out4 == groups).all()),
          "dma4d: both layouts sum the ones block exactly")
    for row in lab["static"]:
        print(f"# phase 3: static chain dynamic={row['dynamic']}, "
              f"{row['warps']} warps a column: R={perf_static_probe.R_LO} "
              f"{row[f'R{perf_static_probe.R_LO}_ms']:.4f} ms, "
              f"R={perf_static_probe.R_HI} "
              f"{row[f'R{perf_static_probe.R_HI}_ms']:.4f} ms, slope "
              f"{row['us_per_op_slope']:.4f} us/op against an FMA floor of "
              f"{row['fma_floor_us_per_op']:.4f} us/op, "
              f"{row['busiest_sm_warps']} warps on the busiest SM ("
              f"{row['timing']})")
        # under the floor, the chain was collapsed: not a time of an op
        check(math.isfinite(row["us_per_op_slope"])
              and not row["below_floor"], "static slope is finite and not "
              "below its FMA floor")


class SyncedPhases:
    """A timer for Burrito.gradient_step: seconds per phase, the card
    synchronised where each phase starts and ends, so a phase's time holds
    its own device work and no other's."""

    def __init__(self):
        self.totals = {}

    @contextlib.contextmanager
    def phase(self, name):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            torch.cuda.synchronize()
            self.totals[name] = (self.totals.get(name, 0.0)
                                 + time.perf_counter() - t0)


@contextlib.contextmanager
def counting_scan_calls():
    """Count the calls of the scan tape's entry points (the engine's route
    without a kernel, and the rooted instance's model gradients) while the
    block runs: {"calls": n}."""
    count = {"calls": 0}
    names = ("log_likelihoods_impl", "ll_and_branch_gradients_impl",
             "log_likelihoods_differentiable")
    saved = {name: getattr(pruning, name) for name in names}

    def counted(fn):
        def call(*args, **kwargs):
            count["calls"] += 1
            return fn(*args, **kwargs)
        return call

    for name, fn in saved.items():
        setattr(pruning, name, counted(fn))
    try:
        yield count
    finally:
        for name, fn in saved.items():
            setattr(pruning, name, fn)


@contextlib.contextmanager
def counting_representations():
    """Count the calls that build unrooted indexer representations while
    the block runs: {"native": calls of the native indexer (each a whole
    tree set), "python": calls of sbn/maps.py's (each one tree)}."""
    count = {"native": 0, "python": 0}
    saved = (_native.PCSPIndexer.unrooted_representations,
             sbn_maps.unrooted_representation)

    def counted(kind, fn):
        def call(*args, **kwargs):
            count[kind] += 1
            return fn(*args, **kwargs)
        return call

    _native.PCSPIndexer.unrooted_representations = counted("native", saved[0])
    sbn_maps.unrooted_representation = counted("python", saved[1])
    try:
        yield count
    finally:
        (_native.PCSPIndexer.unrooted_representations,
         sbn_maps.unrooted_representation) = saved


def vbpi_em(nexus, dev):
    """The vbpi path's EM: on the card in float64, then the numpy backend
    on the same instance; held within 1e-10.  The device loop adds in
    linear space after a shift (as bito_tpu's does), so a PCSP whose mass
    is under exp(-745) of the largest is -inf there beside the numpy
    loop's log value: the same probability, 0."""
    inst = unrooted_instance("em", device=dev)
    inst.read_nexus_file(nexus)
    inst.process_loaded_trees()
    em_ms = []  # the first run loads the torch kernels it uses
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        score = inst.train_expectation_maximization(*VBPI_EM)
        em_ms.append((time.perf_counter() - t0) * 1e3)
    on_card = inst.sbn_parameters
    want = inst.train_expectation_maximization(*VBPI_EM, backend="numpy")
    tiny = inst.sbn_parameters < -745.0
    err = max(np.abs(score - want).max() / np.abs(want).max(),
              np.abs(on_card[~tiny] - inst.sbn_parameters[~tiny]).max())
    print(f"# phase 3: vbpi EM on the card in float64 (alpha, iterations, "
          f"score epsilon = {VBPI_EM}; support {inst.sbn_support.size()}, "
          f"{len(score)} iterations; {em_ms[0]:.1f} ms the first run, "
          f"{em_ms[1]:.1f} ms the second): score {score[-1]:.6f},"
          f" max abs err against the numpy backend {err:.3e} (bound 1e-10), "
          f"{int(tiny.sum())} parameters under exp(-745)")
    check(len(score) == len(want) and np.isneginf(on_card[tiny]).all()
          and np.isfinite(on_card[~tiny]).all() and err <= 1e-10,
          "vbpi: the EM on the card matches the numpy backend")


def vbpi_path(dev, card):
    """The vbpi path: config4's VBPI run on the card (phase 3), checked as
    the module docstring says.  Returns its launch counts."""
    with tempfile.TemporaryDirectory() as tmp:
        nexus, fasta = _synthetic.write_vbpi_inputs(
            tmp, SEED, _synthetic.DS1_TAXA, VBPI_TREES, _synthetic.DS1_SITES,
            _synthetic.DS1_DISTINCT_COLUMNS)
        vbpi_em(nexus, dev)
        burrito = Burrito(
            mcmc_nexus_path=nexus, burn_in_fraction=0.0, fasta_path=fasta,
            phylo_model_specification=PhyloModelSpecification(*VBPI_SPEC),
            branch_model_name="split", scalar_model_name="lognormal",
            optimizer_name="simple", particle_count=VBPI_PARTICLES,
            seed=SEED, device=dev, dtype=PRODUCT_DTYPE)
    inst, eng = burrito.inst, burrito.inst.engine
    check(eng._route(eng._shared_model(inst._params_dict())) == "paired",
          "vbpi: the instance's shared model row takes the paired kernels")

    reset_launches()
    with counting_scan_calls() as scan, counting_representations() as reps:
        burrito.gradient_step()  # warm-up
        timer = SyncedPhases()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(VBPI_STEPS):
            burrito.gradient_step(timer=timer)
        step_ms = (time.perf_counter() - t0) * 1e3 / VBPI_STEPS
        elbo = burrito.estimate_elbo(VBPI_PARTICLES)
        torch.cuda.synchronize()
    counts = {name: KERNELS[name]["wrapper"].launches
              for name in ("paired_ll_onchip", "paired_grad_onchip")}
    read_launches("vbpi")
    print(f"# phase 3: vbpi path: {scan['calls']} calls of the scan tape; "
          f"indexer representations: {reps['native']} native calls (a "
          f"tree set each), {reps['python']} pure-Python calls")
    check(scan["calls"] == 0, "vbpi: no call of the scan tape")
    check(reps["native"] > 0 and reps["python"] == 0,
          "vbpi: the native indexer builds the representations")
    phases = {name: s * 1e3 / VBPI_STEPS for name, s in timer.totals.items()}
    print(f"# phase 3: vbpi step ({_synthetic.DS1_TAXA} taxa, "
          f"{eng.site_pattern.pattern_count} patterns, {VBPI_PARTICLES} "
          f"particles, {'/'.join(VBPI_SPEC)}, split/lognormal/simple; mean of "
          f"{VBPI_STEPS} steps after one, the card synchronised at every "
          f"phase boundary): {step_ms:.2f} ms/step (phases' sum "
          f"{sum(phases.values()):.2f}); " + ", ".join(
              f"{name} {ms:.3f}" for name, ms in phases.items())
          + f" ms; on {card}")
    print(f"# phase 3: vbpi ELBO estimate ({VBPI_PARTICLES} particles): "
          f"{elbo:.6f}")
    check(math.isfinite(elbo), "vbpi: the ELBO is finite")

    # The last sample's trees: the card's LL and gradients in float32
    # against the float64 engine, and the kernels against their plain
    # versions.
    trees = inst.tree_collection.trees
    params = inst._params_dict()
    pgs = inst.phylo_gradients()
    ll = torch.tensor([g.log_likelihood() for g in pgs], dtype=torch.float64)
    grads = torch.as_tensor(np.stack([g.gradient["branch_lengths"]
                                      for g in pgs]), dtype=torch.float64)
    ref = TreeLikelihoodEngine(eng.site_pattern, eng.model, device=dev,
                               dtype=torch.float64)
    ll_ref, g_ref = ref.ll_and_branch_gradients(
        trees, {k: v.double() for k, v in params.items()})
    ll_err = rel_err(ll, ll_ref.cpu())
    g_err = norm_err(grads, g_ref[:, :grads.shape[1]].cpu())
    enc = eng.encode(trees)
    eig, rates, props, clock = eng._model_ingredients(params, len(trees))
    pi, prop = prep.kernel_model(eig, props)
    P, dP = prep.prepare_inputs_grad_q(eig, rates, clock,
                                       eng.branch_length_matrix(trees, enc))
    dst, tip, src, e, mask = eng._paired_tapes(enc)
    on = eng._onchip_tape(enc)
    tips, w = eng._kernel_tips, eng._kernel_weights
    M, N1, C = dst.shape[1], P.shape[1], P.shape[2]
    check(C == 1 and paired.onchip_plan("ll", on.ll_rows, M, N1, C)
          and paired.onchip_plan("grad", on.grad_rows, M, N1, C),
          "vbpi: one rate category, and the trees fit the on-chip bodies")
    ll_ops = (dst, tip, e, P, tips, pi, prop, w)
    grad_ops = (dst, tip, src, e, mask, P, dP, tips, pi, prop, w)
    calls = {"paired_ll_onchip": lambda: paired.paired_log_likelihoods(
                 *ll_ops, onchip=on),
             "paired_grad_onchip": lambda: paired.paired_ll_and_gradients(
                 *grad_ops, onchip=on)}
    ll_k = calls["paired_ll_onchip"]()
    ll_g, g_k = calls["paired_grad_onchip"]()
    ll_p, g_p = paired.paired_ll_and_gradients_ref(
        *[x.double() if x.is_floating_point() else x for x in grad_ops])
    k_err = max(rel_err(ll_k, ll_p), rel_err(ll_g, ll_p), norm_err(g_k, g_p))
    print(f"# phase 3: vbpi last sample ({len(trees)} trees, C={C}): the "
          f"card in float32 against the float64 engine: LL rel err "
          f"{ll_err:.3e}, grad max-abs/max|g| {g_err:.3e}; the paired "
          f"kernels against their float64 plain versions {k_err:.3e} (bound "
          f"{BOUND:g})")
    check(max(ll_err, g_err, k_err) <= BOUND,
          "vbpi: the card's LL and gradients agree with float64")

    # The SBN's topology gradients on the card (float64) against numpy.
    theta = np.array([t.branch_lengths[:-1] for t in trees])
    log_f = burrito.px_log_f(ll.numpy(), theta,
                             burrito.branch_model.px_branch_representation())
    got = inst.topology_gradients(log_f, burrito.use_vimco)
    want = inst.topology_gradients(log_f, burrito.use_vimco, backend="numpy")
    t_err = np.abs(got - want).max() / np.abs(want).max()
    print(f"# phase 3: vbpi topology gradients (VIMCO) on the card in "
          f"float64 against the numpy backend: max-abs/max|g| {t_err:.3e} "
          "(bound 1e-10)")
    check(bool(np.isfinite(got).all()) and t_err <= 1e-10,
          "vbpi: topology gradients on the card match numpy")

    # What the step's kernels and its new topology set cost.
    fl_ll, fl_grad = tree_flops(enc, eng.site_pattern, eng.model, len(trees))
    moved = nbytes(P, tips, pi, prop, w, dst, on.child, e)
    lines = []
    for name, flops, extra in (("paired_ll_onchip", fl_ll,
                                nbytes(on.live_row)),
                               ("paired_grad_onchip", fl_grad,
                                nbytes(src, dP, mask))):
        b_ms, b_by = bound(flops, moved + extra)
        lines.append(f"{name} {cuda_ms(calls[name], 50):.4f} ms (bound "
                     f"{b_ms:.4f} by {b_by}, {counts[name]} launches on the "
                     "path)")
    tape_ms = topology_set_ms(eng.site_pattern, eng.model, trees, 5)
    # The sample's SBN indexer representations (host): the native call the
    # step makes, then sbn/maps.py's on the same trees, which must agree.
    reps_ms, python_ms = [], []
    support = inst.sbn_support
    for _ in range(3):
        inst._indexer_reps_cache = None
        t0 = time.perf_counter()
        native_reps = inst.make_indexer_representations()
        t1 = time.perf_counter()
        python_reps = [sbn_maps.unrooted_representation(
            support.indexer, t.topology, support.size()) for t in trees]
        reps_ms.append((t1 - t0) * 1e3)
        python_ms.append((time.perf_counter() - t1) * 1e3)
    check(native_reps == python_reps, "vbpi: the last sample's native "
          "representations equal the pure-Python ones")
    print(f"# phase 3: vbpi shape ({len(trees)} trees x {eng.pattern_pad} "
          f"patterns, C={C}; CUDA events around 50 calls): " + ", ".join(lines)
          + "; a new topology set, host ms before the first launch: "
          "encoding {:.3f}, paired tapes {:.3f} (the on-chip tape {:.3f} of "
          "it); the sample's SBN indexer representations {:.3f} ms native "
          "(one call), {:.3f} ms pure Python, equal (host, medians of 3); on "
          "{}".format(*tape_ms, float(np.median(reps_ms)),
                      float(np.median(python_ms)), card))
    return counts


def rooted_files(tmp, taxa=ROOTED_TAXA, trees=BATCH):
    """The rooted path's inputs in `tmp`: `trees` dated time trees over
    `taxa` taxa (names t<i>_<date>, branch lengths height differences) and
    a DS1-shaped alignment over them (1,949 columns, 934 distinct), from
    SEED.  Returns (newick path, fasta path)."""
    text, dates = _synthetic.dated_trees_newick(SEED, taxa, trees)
    nwk, fasta = f"{tmp}/rooted.nwk", f"{tmp}/rooted.fasta"
    with open(nwk, "w") as f:
        f.write(text)
    with open(fasta, "w") as f:
        f.write(_synthetic.fasta_text(_synthetic.random_alignment(
            SEED + 1, list(dates), _synthetic.DS1_SITES,
            _synthetic.DS1_DISTINCT_COLUMNS)))
    return nwk, fasta


class HostTimes:
    """Host milliseconds of each call, the card synchronised around it."""

    def __init__(self):
        self.ms = {}

    def __call__(self, name, fn, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        self.ms[name] = (time.perf_counter() - t0) * 1e3
        return out


def rooted_instance_of(files, dev, dtype, times=None):
    """The rooted path's instance (rooted_instance, the user's entry point):
    the trees through the native parser, the dates from the names, the
    alignment, ROOTED_SPEC with the oracle's GTR rates, frequencies and
    Weibull shape (ROOTED_PARAMS), every tree's clock rates ROOTED_RATE.  `times` (a
    HostTimes) times each call."""
    call = times or (lambda name, fn, *a, **k: fn(*a, **k))
    nwk, fasta = files
    inst = rooted_instance("rooted", device=dev, dtype=dtype)
    call("read_newick_file", inst.read_newick_file, nwk)
    call("parse_dates_from_taxon_names", inst.parse_dates_from_taxon_names,
         True)
    inst.read_fasta_file(fasta)
    call("prepare_for_phylo_likelihood", inst.prepare_for_phylo_likelihood,
         PhyloModelSpecification(*ROOTED_SPEC))
    block = inst.get_phylo_model_param_block_map()
    for key, value in ROOTED_PARAMS.items():
        block[key][:] = value
    for state in inst.tree_states:
        state.rates[:] = ROOTED_RATE
    return inst


def rooted_parity(files, dev):
    """Phase 2 on the rooted trees: both paired kernels, through their
    wrappers, on the rooted instance's operands (bifurcating roots,
    substitution lengths rate x time, Weibull4) against their plain
    versions in float64.  Returns {kernel: (its call on these operands,
    its bound)} for phase 3's times."""
    inst = rooted_instance_of(files, dev, PRODUCT_DTYPE)
    eng, trees = inst.engine, inst.tree_collection.trees
    params = inst._params_dict()
    bl = inst._subst_branch_lengths()
    enc = eng.encode(trees)
    eig, rates, props, clock = eng._model_ingredients(params, len(trees))
    pi, prop = prep.kernel_model(eig, props)
    P, dP = prep.prepare_inputs_grad_q(eig, rates, clock, bl)
    dst, tip, src, e, mask = eng._paired_tapes(enc)
    on = eng._onchip_tape(enc)
    tips, w = eng._kernel_tips, eng._kernel_weights
    M, N1, C = dst.shape[1], P.shape[1], P.shape[2]
    check(paired.onchip_plan("ll", on.ll_rows, M, N1, C)
          and paired.onchip_plan("grad", on.grad_rows, M, N1, C),
          "rooted: the trees fit the on-chip bodies")
    ll_ops = (dst, tip, e, P, tips, pi, prop, w)
    grad_ops = (dst, tip, src, e, mask, P, dP, tips, pi, prop, w)
    ll_k = paired.paired_log_likelihoods(*ll_ops, onchip=on)
    ll_g, g_k = paired.paired_ll_and_gradients(*grad_ops, onchip=on)
    ll_p, g_p = paired.paired_ll_and_gradients_ref(
        *[x.double() if x.is_floating_point() else x for x in grad_ops])
    errs = (rel_err(ll_k, ll_p), rel_err(ll_g, ll_p), norm_err(g_k, g_p))
    print(f"# phase 2: rooted trees ({enc.num_taxa} taxa, bifurcating "
          f"roots, {len(trees)} trees x {eng.pattern_pad} patterns, C={C}): "
          f"paired_ll_onchip LL rel err {errs[0]:.3e}; paired_grad_onchip "
          f"LL rel err {errs[1]:.3e}, grad max-abs/max|g| {errs[2]:.3e} "
          f"(bound {BOUND:g}, plain version in float64 on the same operands)")
    check(max(errs) <= BOUND, "rooted: the paired kernels agree with their "
          "plain versions")
    fl_ll, fl_grad = tree_flops(enc, eng.site_pattern, eng.model, len(trees))
    moved = nbytes(P, tips, pi, prop, w, dst, on.child, e)
    calls = {"paired_ll_onchip": (
                 lambda: paired.paired_log_likelihoods(*ll_ops, onchip=on),
                 bound(fl_ll, moved + nbytes(on.live_row) + len(trees) * 4)),
             "paired_grad_onchip": (
                 lambda: paired.paired_ll_and_gradients(*grad_ops, onchip=on),
                 bound(fl_grad, moved + nbytes(src, dP, mask)
                       + len(trees) * (1 + enc.num_slots) * 4))}
    return calls


def rooted_path(files, dev, card, kernel_calls):
    """The rooted path (phase 3): rooted_instance on the card in float32,
    driven as a user drives it, then held against the same instance in
    float64 on the card (the scan tape), as the module docstring says."""
    times = HostTimes()
    reset_launches()
    with counting_scan_calls() as scan:
        inst = rooted_instance_of(files, dev, PRODUCT_DTYPE, times)
        ll = times("log_likelihoods", inst.log_likelihoods)
        ll0 = times("log_likelihoods (no Jacobian)", inst.log_likelihoods,
                    include_log_det_jacobian=False)
        pgs = times("phylo_gradients", inst.phylo_gradients)
        times("process_loaded_trees", inst.process_loaded_trees)
        times("train_simple_average", inst.train_simple_average)
        usp = times("unconditional_subsplit_probabilities",
                    inst.unconditional_subsplit_probabilities)
        torch.cuda.synchronize()
    counts = {name: KERNELS[name]["wrapper"].launches
              for name in ("paired_ll_onchip", "paired_grad_onchip")}
    read_launches("rooted")
    trees, eng = inst.tree_collection.trees, inst.engine
    print(f"# phase 3: rooted path ({eng.site_pattern.num_taxa} dated taxa, "
          f"{len(trees)} time trees, {eng.site_pattern.site_count} columns, "
          f"{eng.site_pattern.pattern_count} patterns, "
          f"{'+'.join(ROOTED_SPEC)} at shape "
          f"{ROOTED_PARAMS['site_model_parameters'][0]}, clock rate "
          f"{ROOTED_RATE}): "
          f"{scan['calls']} calls of the scan tape (the model gradients' "
          "postorder and adjoint preorder)")
    check(eng._route(eng._shared_model(inst._params_dict())) == "paired",
          "rooted: the instance's shared model row takes the paired kernels")
    check(scan["calls"] == 1, "rooted: only the model gradients (one "
          "reverse pass for both blocks) take the scan tape")
    # The same instance in float64 on the card: the engine's scan tape.
    ref = rooted_instance_of(files, dev, torch.float64)
    ll_ref = ref.log_likelihoods()
    ll0_ref = ref.log_likelihoods(include_log_det_jacobian=False)
    pgs_ref = ref.phylo_gradients()
    outs = [ll, ll0] + [g for pg in pgs for g in pg.gradient.values()]
    check(all(np.isfinite(x).all() for x in outs)
          and ll.shape == (len(trees),)
          and all(set(pg.gradient) == set(ROOTED_KEYS) for pg in pgs),
          "rooted: finite outputs of the expected shapes and keys")
    errs = {"LL": max(rel_err(torch.as_tensor(ll), torch.as_tensor(ll_ref)),
                      rel_err(torch.as_tensor(ll0),
                              torch.as_tensor(ll0_ref)))}
    for key in ROOTED_KEYS:
        errs[key] = norm_err(
            torch.as_tensor(np.stack([pg.gradient[key] for pg in pgs])),
            torch.as_tensor(np.stack([pg.gradient[key] for pg in pgs_ref])))
    print("# phase 3: rooted path against the instance in float64 on the "
          "card (LL rel err, gradients max-abs/max|g|): " + ", ".join(
              f"{key} {err:.3e}" for key, err in errs.items())
          + f" (bound {BOUND:g})")
    check(max(errs.values()) <= BOUND,
          "rooted: the card's LL and every gradient agree with float64")
    check(len(usp) > 0 and all(0.0 <= p <= 1.0 + 1e-12 for p in usp.values()),
          "rooted: unconditional subsplit probabilities in [0, 1]")
    lines = []
    for name, (call, (b_ms, b_by)) in kernel_calls.items():
        lines.append(f"{name} {cuda_ms(call, 20):.4f} ms (bound {b_ms:.4f} "
                     f"by {b_by}, {counts[name]} launches on the path)")
    print(f"# phase 3: rooted shape ({len(trees)} trees x {eng.pattern_pad} "
          f"patterns, C={eng.model.category_count}; CUDA events around 20 "
          "calls): " + ", ".join(lines) + "; host ms of each call: "
          + ", ".join(f"{name} {ms:.3f}" for name, ms in times.ms.items())
          + f"; {len(usp)} subsplits; on {card}")
    return counts


# -- the chunk lab (row 11) ---------------------------------------------------
CHUNK_CHECKED = ("v0", "w4", "w8", "norescale", "notips", "fixstore", "nodot",
                 "unroll")


def chunk_tapes(enc, W, dev, flagship_tapes):
    """(post_dst, tip_slot, post_e, on-chip tape) of the chunked schedule at
    width W: the engine's own at chunked.W (`flagship_tapes`), else built."""
    if W == chunked.W:
        return flagship_tapes
    ce = chunked.build_chunked_encoding(enc, W)
    dst, tip, e = (torch.as_tensor(x, dtype=torch.int32, device=dev)
                   for x in (ce.post_dst, ce.tip_slot, ce.post_e))
    return dst, tip, e, chunked.onchip_tape(ce.post_dst, ce.tip_slot, dev)


def chunk_lab_parity(enc, ops, flagship_tapes, dev, errs):
    """Phase 2 for chunk_variant: each of the chunk lab's kernel variants
    against its float64 plain version (perf_chunk_lab.chunk_variant_ref)
    on the flagship's chunked operands: the LL within BOUND relative
    (notips: within BOUND per site of the plain version's near-zero LL;
    nodot, not a likelihood: the same non-finite rows, the finite ones,
    per-site log values near 0 here (the padded all-ones columns), within
    BOUND).  Prints every variant's error before it checks them.  Fills
    errs["chunk_variant"] with the worst LL error of the likelihood
    variants."""
    P, tips, pi, prop, w = ops
    w64 = w.double()
    worst, worst_abs, lines, results = 0.0, 0.0, [], []
    for name in CHUNK_CHECKED:
        variant, W = perf_chunk_lab.parse_name(name)
        dst, tip, e, on = chunk_tapes(enc, W, dev, flagship_tapes)
        rows = perf_chunk_lab.chunk_variant(dst, tip, e, P, tips, pi, prop,
                                            variant=variant, onchip=on)
        torch.cuda.synchronize()
        plain = perf_chunk_lab.chunk_variant_ref(dst, tip, e, P, tips, pi,
                                                 prop, variant=variant)
        ll, ll_p = rows.double() @ w64, plain @ w64
        if name == "nodot":
            fin = torch.isfinite(plain)
            same = torch.equal(torch.isfinite(rows), fin)
            err = ((rows.double() - plain)[fin].abs().max().item()
                   if same and fin.any() else (0.0 if same else math.inf))
            what = (f"rows max-abs err {err:.3e} ({int(fin.sum())} finite, "
                    f"max |row| {plain[fin].abs().max().item():.3e})")
        elif name == "notips":
            err = ((ll - ll_p).abs().max() / w64.sum()).item()
            what = (f"LL {ll.abs().max().item():.3e} (plain "
                    f"{ll_p.abs().max().item():.3e}), error per site "
                    f"{err:.3e}")
        else:
            err = rel_err(ll, ll_p)
            worst = max(worst, err)
            worst_abs = max(worst_abs, (ll - ll_p).abs().max().item())
            what = f"LL rel err {err:.3e}"
        lines.append(f"{name} {what}")
        results.append((name, err))
    errs["chunk_variant"] = (worst, worst_abs)
    print("# phase 2: chunk_variant against its float64 plain version on "
          f"the flagship's chunked operands (bound {BOUND:g}): "
          + "; ".join(lines))
    for name, err in results:
        check(err <= BOUND, f"chunk_variant {name} agrees with its plain "
              "version")


def run_chunklab(dev):
    """The chunklab path: the chunk lab's entry point, as `python -m
    bito_tpu_torch.perflab chunk` runs it, over every name at its five
    sweeps of perf_chunk_lab.ITERS calls, whose best phase 4 reports.
    Returns (the lab's Flagship, its results)."""
    print(f"# phase 3: chunklab path (python -m bito_tpu_torch.perflab "
          f"chunk: {' '.join(perf_chunk_lab.NAMES)}; five sweeps each)")
    flag = perf_chunk_lab.Flagship(dev)
    return flag, perf_chunk_lab.run(perf_chunk_lab.NAMES, flag, repeats=5)


def check_chunklab(flag, out):
    """Phase 3's checks of the chunklab path: every name timed; the
    likelihood variants finite; v0 equal to chunked_ll_onchip's rows on the
    same operands; w4, w8, norescale, fixstore and unroll within BOUND of
    v0."""
    check(all(ms > 0 for ms, _ in out.values()), "chunklab: every name timed")
    ll0 = out["v0"][1]
    for name in ("w2", "w4", "w8", "norescale", "fixstore", "unroll"):
        ll = out[name][1]
        check(bool(torch.isfinite(ll).all()) and rel_err(ll, ll0) <= BOUND,
              f"chunklab {name} agrees with v0")
    dst, tip, e, on = flag.tapes(chunked.W)
    P = flag.P()
    plan = chunked.ll_plan(on.ll_rows, dst.shape[1], P.shape[1], 4)
    ship = chunked.chunked_ll_onchip(dst, on, e, P, flag.tips, flag.pi,
                                     flag.props, plan)
    v0 = perf_chunk_lab.chunk_variant(dst, tip, e, P, flag.tips, flag.pi,
                                      flag.props, variant="v0", onchip=on)
    check(torch.equal(ship, v0), "chunklab: v0 equals chunked_ll_onchip's "
          "rows on the same operands")
    print("# phase 3: chunklab: v0's rows equal chunked_ll_onchip's; w4, w8 "
          "at most {:.3e} from v0 (LL rel err)".format(max(
              rel_err(out[n][1], ll0) for n in ("w4", "w8"))))


def chunk_lab_times(flag, res, enc_flops, card):
    """Phase 4 for row 11: each kernel variant alone (perflab.graph_ms, the
    launches into an output allocated once) beside its bound (the LL's
    FLOPs of bench.py at PEAK_FLOPS, nodot's without the evolves, against
    the bytes at PEAK_BYTES), then the chunklab path's results `res` (the
    best of five sweeps, as evals/s), and preponly's share of a flagship
    LL call."""
    fl_ll, fl_evolve = enc_flops
    dst, _tip, e, on = flag.tapes(chunked.W)
    P = flag.P()
    out = torch.empty((dst.shape[0], flag.tips.shape[-1]), device=P.device,
                      dtype=torch.float32)
    moved = nbytes(dst, on.child, on.live_row, e, P, flag.tips, flag.pi,
                   flag.props, out)
    lines = []
    for variant in perf_chunk_lab.VARIANT_CODES:
        rows = perf_chunk_lab.variant_rows(variant, dst, on)
        plan = perf_chunk_lab.variant_plan(variant, rows, dst.shape[1],
                                           P.shape[1], 4)
        ms = graph_ms(lambda: perf_chunk_lab.launch_chunk_variant(
            dst, on, e, P, flag.tips, flag.pi, flag.props, plan, out,
            variant=variant, rows=rows), 50,
            counter=perf_chunk_lab.chunk_variant)
        b_ms, b_by = bound(fl_ll - (fl_evolve if variant == "nodot" else 0),
                           moved)
        lines.append(f"{variant} {ms:.4f} ms (bound {b_ms:.4f} by {b_by}, "
                     f"{plan.cols * plan.lanes // 32} warps, {rows} rows)")
        check(ms >= b_ms, f"chunk_variant {variant} within its bound")
    print(f"# phase 4: chunk_variant, each variant alone ({GRAPH_TIMING}, "
          f"50 launches; {BATCH} trees x {flag.tips.shape[-1]} patterns): "
          + ", ".join(lines) + f" on {card}")
    per_call = {name: ms / perf_chunk_lab.ITERS for name, (ms, _) in
                res.items()}
    print("# phase 4: chunk lab, ms per call (best of 5 sweeps of "
          f"{perf_chunk_lab.ITERS} calls; evals/s = {BATCH} / ms): "
          + ", ".join(f"{n} {ms:.4f} ({BATCH / ms * 1e3:.1f} evals/s)"
                      for n, ms in per_call.items())
          + f"; preponly (P from float64 model ingredients, cast) is "
          f"{per_call['preponly'] / per_call['v0']:.3f} of v0's call, the "
          f"kernel alone (fixedop) {per_call['fixedop'] / per_call['v0']:.3f};"
          f" on {card}")
    return per_call


# -- the gp path ----------------------------------------------------------------
def gp_files(tmp):
    """The gp path's inputs, written to `tmp`: a synthetic credible set
    (_synthetic.credible_set_newick: 12 rooted trees over DS1's 27 taxa,
    each the first after 2 random NNIs, with branch lengths) and a
    DS1-shaped alignment (1,949 columns, 934 distinct).  Returns (newick,
    fasta)."""
    names = _synthetic.taxon_names(_synthetic.DS1_TAXA)
    nwk, fasta = f"{tmp}/credible.nwk", f"{tmp}/ds1_shaped.fasta"
    with open(nwk, "w") as f:
        f.write(_synthetic.credible_set_newick(SEED, _synthetic.DS1_TAXA))
    with open(fasta, "w") as f:
        f.write(_synthetic.fasta_text(_synthetic.random_alignment(
            SEED + 1, names, _synthetic.DS1_SITES,
            _synthetic.DS1_DISTINCT_COLUMNS)))
    return nwk, fasta


def gp_flow(files, dev, dtype, times=None, carry=None):
    """config3's flow through gp_instance (the user's entry point), timed
    by `times` (a HostTimes) where given: read, make_dag, make_gp_engine,
    populate_plvs, compute_likelihoods, the per-PCSP LLs; one
    optimize_branch_lengths_once; estimate_branch_lengths(GP_TOL,
    GP_MAX_ITER); estimate_sbn_parameters; calculate_hybrid_marginals.
    With `carry`, another run's states (after the sweep, after the
    estimate, after the SBN estimate), in convert.gp_state's form, the
    engine takes the first in place of its own sweep, the second before
    the SBN estimate and the third before the hybrid marginals, so that
    each step starts from the other run's numbers.  Returns (instance,
    {what: value}), with "states" this run's three and "sbn_in" the q and
    hybrid marginals that the SBN estimate's softmax takes."""
    call = times or (lambda name, fn, *a, **k: fn(*a, **k))
    nwk, fasta = files
    inst = gp_instance(device=dev, dtype=dtype)
    call("read_fasta_file", inst.read_fasta_file, fasta)
    call("read_newick_file", inst.read_newick_file, nwk)
    call("make_dag", inst.make_dag)
    call("make_gp_engine", inst.make_gp_engine)
    call("populate_plvs", inst.populate_plvs)
    call("compute_likelihoods", inst.compute_likelihoods)
    out = dict(marginal=inst.get_log_marginal_likelihood(),
               pcsp=call("get_per_gpcsp_log_likelihoods",
                         inst.get_per_gpcsp_log_likelihoods))
    if carry is None:
        call("optimize_branch_lengths_once",
             inst.optimize_branch_lengths_once)
    else:
        gp_state_from_numpy(inst.get_gp_engine(), **carry[0])
    states = [gp_state(inst.get_gp_engine())]
    out["estimate"] = call("estimate_branch_lengths",
                           inst.estimate_branch_lengths, GP_TOL, GP_MAX_ITER)
    out["plv_finite"] = bool(torch.isfinite(inst.get_gp_engine().plv).all())
    states.append(gp_state(inst.get_gp_engine()))
    if carry is not None:
        gp_state_from_numpy(inst.get_gp_engine(), **carry[1])
    # the per-PCSP LLs that the SBN estimate's softmax takes
    inst.populate_plvs()
    inst.compute_likelihoods()
    out["sbn_ll"] = inst.get_per_gpcsp_log_likelihoods()
    out["sbn_in"] = (inst.get_sbn_parameters(),
                     inst.get_hybrid_marginals().copy())
    call("estimate_sbn_parameters", inst.estimate_sbn_parameters)
    out["sbn_marginal"] = inst.get_log_marginal_likelihood()
    out["q"] = inst.get_sbn_parameters()
    states.append(gp_state(inst.get_gp_engine()))
    out["states"] = states
    if carry is not None:
        gp_state_from_numpy(inst.get_gp_engine(), **carry[2])
    call("calculate_hybrid_marginals", inst.calculate_hybrid_marginals)
    out["hybrid"] = inst.get_hybrid_marginals().copy()
    return inst, out


def gp_path(files, dev, card):
    """The gp path (phase 3): config3's flow on the card in float32, no
    hand-written kernel launched, held against the same flow in float64
    on the card: the log marginal and every per-PCSP LL at the start's
    branch lengths within BOUND relative; from the float32 run's lengths
    after its sweep (carried into the float64 engine), the log marginal
    after estimate_branch_lengths within BOUND relative (the objective,
    not the argmin: Brent in float32 stops at about sqrt(eps)); then, from
    the float32 run's branch lengths after the estimate, the
    log marginal after estimate_sbn_parameters within BOUND relative, and
    the SBN parameters within Q_BOUND absolute (at DS1's magnitudes, LLs
    near -7e4, float32 holds the per-PCSP LLs that the softmax takes to
    about 1e-2, and q moves with them); the control, the same softmax on
    float64's LLs rounded to Q_CONTROL_BITS significand bits, must exceed
    Q_BOUND; and from the float32 run's SBN parameters, every finite
    hybrid marginal within BOUND relative.  Returns (the float32 instance,
    its HostTimes)."""
    times = HostTimes()
    reset_launches()
    inst, out = gp_flow(files, dev, PRODUCT_DTYPE, times)
    torch.cuda.synchronize()
    read_launches("gp")
    dag, eng = inst.get_dag(), inst.get_gp_engine()
    print(f"# phase 3: gp path (config3's flow at DS1's shape: "
          f"{dag.taxon_count} taxa, {eng.site_pattern.site_count} columns, "
          f"{eng.S} patterns, a synthetic credible set of "
          f"{inst.tree_count()} trees): DAG of "
          f"{dag.node_count_without_dag_root()} nodes and {dag.edge_count()} "
          f"edges, {len(eng.schedule.rootward)} rootward and "
          f"{len(eng.schedule.leafward)} leafward levels, "
          f"{int(dag.topology_count())} topologies; no hand-written kernel "
          "launched")
    ref_inst, ref = gp_flow(files, dev, torch.float64, carry=out["states"])
    hyb, hyb_ref = out["hybrid"], ref["hybrid"]
    fin = np.isfinite(hyb_ref)
    errs = dict(
        marginal=abs(out["marginal"] - ref["marginal"]) / abs(ref["marginal"]),
        pcsp=float(np.max(np.abs(out["pcsp"] - ref["pcsp"])
                          / np.abs(ref["pcsp"]))),
        estimate=abs(out["estimate"] - ref["estimate"]) / abs(ref["estimate"]),
        sbn=abs(out["sbn_marginal"] - ref["sbn_marginal"])
        / abs(ref["sbn_marginal"]),
        sbn_ll=float(np.max(np.abs(out["sbn_ll"] - ref["sbn_ll"])
                            / np.abs(ref["sbn_ll"]))),
        hybrid=float(np.max(np.abs(hyb[fin] - hyb_ref[fin])
                            / np.abs(hyb_ref[fin]))) if fin.any() else 0.0)
    print("# phase 3: gp path against the same flow in float64 on the card "
          "(relative errors): " + ", ".join(f"{k} {v:.3e}"
                                            for k, v in errs.items())
          + f" (bound {BOUND:g}); log marginal {out['marginal']:.4f} at the "
          f"start, {out['estimate']:.4f} after estimate_branch_lengths("
          f"{GP_TOL:g}, {GP_MAX_ITER}) (float64 {ref['estimate']:.4f}); "
          f"{int(fin.sum())} finite hybrid marginals; host ms of each call: "
          + ", ".join(f"{n} {ms:.1f}" for n, ms in times.ms.items())
          + f"; on {card}")
    check(out["plv_finite"] and np.isfinite(out["pcsp"]).all()
          and np.isfinite([out["marginal"], out["estimate"]]).all(),
          "gp: finite PLVs, per-PCSP LLs and marginals")
    check(out["pcsp"].shape == (dag.edge_count(),), "gp: one LL a PCSP")
    check(out["estimate"] > out["marginal"], "gp: the estimate raised the "
          "log marginal")
    check(np.array_equal(np.isfinite(hyb), fin) and fin.any(),
          "gp: the same finite hybrid marginals")
    check(max(errs.values()) <= BOUND, "gp: float32 on the card agrees "
          "with float64")
    q_err = float(np.max(np.abs(out["q"] - ref["q"])))
    controls = {bits: float(np.max(np.abs(sbn_q_of_rounded(
        ref_inst.get_gp_engine(), ref["sbn_ll"], *ref["sbn_in"], bits)
        - ref["q"]))) for bits in sorted({53, 22, 20, 18, Q_CONTROL_BITS},
                                   reverse=True)}
    print(f"# phase 3: gp SBN parameters: max |q - q64| {q_err:.3e} "
          f"(bound {Q_BOUND:g}); the per-PCSP LLs' largest absolute error "
          f"{float(np.max(np.abs(out['sbn_ll'] - ref['sbn_ll']))):.3e}; "
          "controls, max |q - q64| of the softmax on float64's LLs rounded "
          "to n significand bits: " + ", ".join(
              f"n={b} {e:.3e}" for b, e in controls.items()))
    # at 53 bits the control recomputes float64's q, up to the card's
    # unordered float64 sums (about 1e-11 in an LL near -7e4)
    check(controls[53] <= 1e-9, "gp: the control's softmax is the SBN "
          "estimate's")
    check(controls[Q_CONTROL_BITS] > Q_BOUND, "gp: the q check's control "
          "fails it")
    check(q_err <= Q_BOUND, "gp: the SBN estimate agrees with float64")
    return inst, times


def sbn_q_of_rounded(eng, ll, q, hybrid, bits):
    """The SBN estimate's softmax (engine.update_sbn_probabilities' call
    of _sbn_segment_softmax) on `eng`'s segments, from SBN parameters `q`
    and hybrid marginals `hybrid`, on the per-PCSP LLs `ll` rounded to
    `bits` significand bits: the q check's control."""
    m, e = np.frexp(ll)
    ll = np.ldexp(np.round(m * 2.0 ** bits) / 2.0 ** bits, e)
    seg_ids, nseg, singleton, covered = eng._sbn_segment_arrays()
    return eng._host(_sbn_segment_softmax(
        eng._tensor(q), eng._tensor(ll), eng._tensor(hybrid), seg_ids, nseg,
        singleton, covered))


class CudaOps(TorchDispatchMode):
    """Counts the torch operations whose (first) output is a CUDA tensor
    (views excluded): about one kernel each, at a fraction of a profiler's
    cost on a program of 1e5 kernels."""

    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        first = out[0] if isinstance(out, (tuple, list)) and out else out
        if (not func.is_view and isinstance(first, torch.Tensor)
                and first.is_cuda):
            self.count += 1
        return out


def gp_times(inst, times, card):
    """Phase 4 for the gp path: config3's metrics on the gp path's float32
    instance, the card synchronised: ms per populate + per-PCSP pass
    (populate_plvs, compute_likelihoods, get_per_gpcsp_log_likelihoods;
    best of GP_REPS) and ms per optimize sweep (the gp path's
    optimize_branch_lengths_once, from its HostTimes `times`); the device
    kernels of a populate pass (torch.profiler) and the torch operations
    on the card of a pass and of a sweep (CudaOps, one further sweep)."""
    eng = inst.get_gp_engine()

    def populate_pass():
        eng.populate_plvs()
        eng.compute_likelihoods()
        eng.per_gpcsp_log_likelihoods()

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    populate_pass()
    pop_ms = min(timed(populate_pass) for _ in range(GP_REPS))
    opt_ms = times.ms["optimize_branch_lengths_once"]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        populate_pass()
        torch.cuda.synchronize()
    kernels = sum(1 for ev in prof.events()
                  if ev.device_type == torch.autograd.DeviceType.CUDA)
    ops = {}
    for name, fn in (("populate", populate_pass),
                     ("sweep", eng.optimize_branch_lengths_once)):
        with CudaOps() as counter:
            fn()
        ops[name] = counter.count
    print(f"# phase 4: gp (config3's metrics, the card synchronised): "
          f"populate + per-PCSP pass {pop_ms:.3f} ms (best of {GP_REPS}; "
          f"{kernels} device kernels by torch.profiler, {ops['populate']} "
          f"torch operations on the card), optimize sweep {opt_ms:.3f} ms "
          f"(the gp path's call; {ops['sweep']} torch operations on the "
          f"card), {inst.get_dag().edge_count()} edges; on {card}")
    return pop_ms, opt_ms


# -- the nni path ---------------------------------------------------------------
def no_launches(what):
    """Check that no hand-written kernel launched (since the last reset)."""
    counts = {n: spec["wrapper"].launches for n, spec in KERNELS.items()}
    check(not any(counts.values()), f"{what}: no hand-written kernel "
          f"launched ({ {n: c for n, c in counts.items() if c} })")


def nni_instance(paths, dev, dtype, scoring):
    """A gp_instance as nni_search builds one: the FASTA and the seed
    Newick read, make_dag, then for TP scoring make_tp_engine and its two
    take-first setters, for GP scoring make_gp_engine and
    take_first_branch_length."""
    inst = gp_instance(device=dev, dtype=dtype)
    inst.read_fasta_file(paths["alignment.fasta"])
    inst.read_newick_file(paths["seed.nwk"])
    inst.make_dag()
    if scoring == "gp_likelihood":
        inst.make_gp_engine()
        inst.take_first_branch_length()
    else:
        inst.make_tp_engine()
        inst.tp_engine_set_branch_lengths_by_taking_first()
        inst.tp_engine_set_choice_map_by_taking_first()
    return inst


def timed_method(obj, name, timer, phase):
    """Wrap obj.name so that each call runs inside timer.phase(phase)."""
    fn = getattr(obj, name)

    def call(*args, **kwargs):
        with timer.phase(phase):
            return fn(*args, **kwargs)

    setattr(obj, name, call)


def batched_against_serial(search, label):
    """Hold the batched scorer (float64 on the card) against the serial
    numpy scorer on the search's next candidate set: within SCORER_BOUND
    relative, or ROUNDED_BOUND where a Brent step was decided by rounding.
    Returns (candidates, rounded, worst relative error of the others,
    torch operations on the card of one batched call)."""
    eng = search.engine
    nnis = sorted(search.new_adjacent or search.adjacent, key=nni_sort_key)
    best = eng.build_best_edge_map(nnis)
    batched, serial, rounded = batch_scorer.scores_with_brent_traces(
        eng, nnis, best)
    with CudaOps() as counter:
        eng.score_proposed_nnis_batched(nnis, best)
    ops = counter.count
    rel = np.abs(batched - serial) / np.abs(serial)
    worst = float(rel[~rounded].max()) if (~rounded).any() else 0.0
    print(f"# phase 3: nni batched scorer ({label} candidate set, "
          f"{len(nnis)} candidates): float64 on the card against the serial "
          f"numpy scorer, worst rel err {worst:.3e} (bound {SCORER_BOUND:g}) "
          f"over {int((~rounded).sum())}; {int(rounded.sum())} with a Brent "
          f"step decided by rounding, worst rel err "
          f"{float(rel[rounded].max()) if rounded.any() else 0.0:.3e} "
          f"(bound {ROUNDED_BOUND:g}); {ops} torch operations on the card "
          "in one batched call")
    check(np.isfinite(batched).all() and worst <= SCORER_BOUND
          and bool(np.all(rel[rounded] <= ROUNDED_BOUND)),
          f"nni: the batched scorer agrees with the serial scorer ({label})")
    return len(nnis), int(rounded.sum()), worst, ops


def faithful_search(paths, dev, card):
    """config5's product path: the faithful TP-likelihood search through
    gp_instance (make_nni_engine's default scoring) at DS1's shape,
    NNI_ITERS iterations at opt_max NNI_OPT_MAX, top-1, with nni/search.py's
    posterior tracking.  First the TP engine's top_tree_log_likelihoods
    (paired_ll_onchip) against float64.  The batched scorer is held to
    the serial scorer on the first and the last iteration's candidate
    sets; the search itself launches no hand-written kernel.  Returns
    {what: value} for phase 4 and the records."""
    inst = nni_instance(paths, dev, PRODUCT_DTYPE, "tp_likelihood")
    tp = inst.get_tp_engine()
    reset_launches()
    top = tp.top_tree_log_likelihoods()
    torch.cuda.synchronize()
    read_launches("nni")
    top_launches = paired.paired_ll_onchip.launches
    twin = TreeLikelihoodEngine(tp.site_pattern,
                                PhyloModel(PhyloModelSpecification()),
                                device=dev, dtype=torch.float64)
    top64 = twin.log_likelihoods(tp.top_trees(), {}).cpu().numpy()
    top_err = float(np.max(np.abs(top - top64) / np.abs(top64)))
    print(f"# phase 3: nni TP engine top_tree_log_likelihoods ("
          f"{len(top)} DAG edges' top trees, JC69, C = 1): "
          f"{top_launches} launches of paired_ll_onchip, rel err against "
          f"float64 {top_err:.3e} (bound {BOUND:g})")
    check(np.isfinite(top).all() and top_err <= BOUND,
          "nni: top-tree LLs agree with float64")

    eng = inst.make_nni_engine("tp_likelihood")
    search = eng.search
    check(search.engine.device == dev, "nni: the faithful engine's scorer "
          "runs on the card")
    search.engine.optimize_max_iter = NNI_OPT_MAX
    eng.set_top_k_score_filtering_scheme(1)
    pp_maps = PosteriorProbabilityMaps(
        paths["alignment.fasta"], paths["credible.nwk"], paths["pp.csv"],
        paths["pcsp_pp.csv"])
    results = SearchResults()
    timer = SyncedPhases()
    timed_method(search.engine, "score_adjacent_nnis", timer, "score")
    timed_method(search, "_add_accepted_nnis_to_dag", timer, "accept")
    timed_method(search, "run_post_loop", timer, "post")
    reset_launches()
    eng.run_init()
    cred0 = pp_maps.get_credible_edge_count(eng.dag)[0]
    checks, margins, loop_s = [], [], 0.0
    for it in range(1, NNI_ITERS + 1):
        if it in (1, NNI_ITERS):
            checks.append(batched_against_serial(
                search, "first" if it == 1 else "last"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        accepted = eng.run_main_loop()
        loop_s += time.perf_counter() - t0
        ranked = sorted(search.scored.values(), reverse=True)
        margins.append(ranked[0] - ranked[1] if len(ranked) > 1 else math.inf)
        results.add_entry(it, eng.dag, eng, pp_maps, eng.scored_nnis())
        check(accepted, f"nni: the faithful search accepted at iteration {it}")
        t0 = time.perf_counter()
        eng.run_post_loop()
        torch.cuda.synchronize()
        loop_s += time.perf_counter() - t0
    no_launches("nni faithful search")
    cred = pp_maps.get_credible_edge_count(eng.dag)[0]
    phases = {n: v * 1e3 / NNI_ITERS for n, v in timer.totals.items()}
    ips = NNI_ITERS / loop_s
    print(f"# phase 3: nni faithful search (gp_instance, make_nni_engine "
          f"tp_likelihood; {eng.dag.taxon_count} taxa, "
          f"{search.engine.site_pattern.pattern_count} patterns, opt_max "
          f"{NNI_OPT_MAX}, top-1): {NNI_ITERS} iterations, "
          f"{len(results.rows)} accepted, {ips:.3f} iterations/s; an "
          "iteration (ms, the card synchronised at phase edges): "
          + ", ".join(f"{n} {ms:.1f}" for n, ms in phases.items())
          + f"; DAG {eng.dag.node_count_without_dag_root()} nodes, "
          f"{eng.dag.edge_count()} edges, credible edges {cred0} -> {cred} "
          f"of {pp_maps.get_credible_edge_total()}; top-1 margins (best - "
          "second score) " + ", ".join(f"{m:.4g}" for m in margins)
          + f"; on {card}")
    check(len(results.rows) == NNI_ITERS
          and all(np.isfinite(r["score"]) for r in results.rows),
          "nni: one finite accepted score an iteration")
    return dict(ips=ips, phases=phases, checks=checks,
                top_launches=top_launches)


def pending_candidates(eng):
    """(keys, trees) that the whole-tree engine's next score_adjacent_nnis
    scores: the adjacent NNIs not yet scored, each with its candidate tree
    (a fresh copy)."""
    keys, trees = [], []
    for key, nni in eng.adjacent.items():
        if key in eng.scored:
            continue
        tree = eng._candidate_tree(nni)
        if tree is not None:
            keys.append(key)
            trees.append(tree)
    return keys, trees


def whole_tree_search(paths, dev, scoring, card):
    """The whole-tree NNIEngine at DS1's shape on the card in float32,
    NNI_WHOLE_ITERS iterations, top-1.  Each iteration's candidate trees
    are scored by a float64 engine on the card from the float32 run's own
    state.  With TP likelihood: the float32 run's candidate trees, with
    the branch lengths its optimize_selected_branches gave them, by the
    float64 engine (the scan tape) within BOUND relative of the float32
    scores; and, printed without a bound, the scores that float64 reaches
    when it optimizes the same trees' new edges itself (two Jacobi rounds
    of Brent from the same lengths, which float32's rounding can steer to
    another point: a branch at the lower bound moves a conflicting site's
    LL by log t).  With parsimony: Sankoff in float64, equal.  Returns (iterations/s, the last candidate set's trees,
    their site patterns, the iteration's phases, paired_ll_onchip's
    launches)."""
    inst = nni_instance(paths, dev, PRODUCT_DTYPE, scoring)
    likelihood = scoring == "tp_likelihood"
    sp = inst.get_tp_engine().site_pattern
    if likelihood:  # make_nni_engine's tp_likelihood is the faithful search
        eng = NNIEngine(inst.get_dag(), sp, inst.tree_collection.trees,
                        device=dev, dtype=PRODUCT_DTYPE)
        twin = TreeLikelihoodEngine(sp, PhyloModel(PhyloModelSpecification()),
                                    device=dev, dtype=torch.float64)
    else:
        eng = inst.make_nni_engine(scoring)
        twin = SankoffHandler(sp, device=dev, dtype=torch.float64)
    eng.timer = SyncedPhases()
    timed_method(eng, "score_adjacent_nnis", eng.timer, "score")
    timed_method(eng, "_rebuild_engines", eng.timer, "accept.rebuild")
    eng.set_top_k_score_filtering_scheme(1)
    reset_launches()
    eng.run_init()
    errs, margins, loop_s, trees = [], [], 0.0, []
    for it in range(NNI_WHOLE_ITERS):
        keys, trees = pending_candidates(eng)
        if likelihood:
            indexer = eng.dag.build_edge_indexer()
            sel = [eng._new_edge_nodes(t, indexer) for t in trees]
            bl = twin.optimize_selected_branches(
                trees, {}, sel, iterations=eng._optimization_iterations)
            for b, t in enumerate(trees):
                t.branch_lengths = bl[b, : t.topology.num_nodes].copy()
            ref = twin.log_likelihoods(trees, {}).cpu().numpy()
        else:
            ref = -twin.run_sankoff(trees)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        check(eng.run_main_loop(), f"nni {scoring}: accepted at {it + 1}")
        torch.cuda.synchronize()
        loop_s += time.perf_counter() - t0
        scores = {**eng.scored, **eng.accepted_scores_this_iter}
        got = np.array([scores[k] for k in keys])
        rest = [eng.scored[k] for k in eng.adjacent if k in eng.scored]
        margins.append(max(eng.accepted_scores_this_iter.values())
                       - max(rest) if rest else math.inf)
        if likelihood:
            mine = [eng._candidate_trees[k] for k in keys]
            kernel_ref = twin.log_likelihoods(mine, {}).cpu().numpy()
            errs.append((float(np.max(np.abs(got - ref) / np.abs(ref))),
                         float(np.max(np.abs(got - kernel_ref)
                                      / np.abs(kernel_ref)))))
        else:
            check(np.array_equal(got, ref), "nni tp_parsimony: Sankoff on "
                  "the card equals the float64 plain version")
        t0 = time.perf_counter()
        eng.run_post_loop()
        torch.cuda.synchronize()
        loop_s += time.perf_counter() - t0
    launches = 0
    if likelihood:
        read_launches("nni")
        launches = paired.paired_ll_onchip.launches
    else:
        no_launches("nni tp_parsimony")
    phases = {n: v * 1e3 / NNI_WHOLE_ITERS for n, v in eng.timer.totals.items()}
    ips = NNI_WHOLE_ITERS / loop_s
    what = ("candidate LLs against float64 on the float32 run's "
            f"optimized trees: worst rel err {max(e[1] for e in errs):.3e} "
            f"(bound {BOUND:g}); against float64's own optimization of the "
            f"same trees (no bound): worst rel err "
            f"{max(e[0] for e in errs):.3e}; {launches} launches of "
            "paired_ll_onchip"
            if likelihood else "Sankoff scores on the card equal to float64's "
            "plain version; no hand-written kernel launched")
    print(f"# phase 3: nni whole-tree engine, {scoring} ({sp.num_taxa} taxa, "
          f"{sp.pattern_count} patterns, top-1): {NNI_WHOLE_ITERS} iterations,"
          f" {len(keys)} candidates in the last, {ips:.3f} iterations/s; an "
          "iteration (ms, the card synchronised at phase edges): "
          + ", ".join(f"{n} {ms:.1f}" for n, ms in phases.items())
          + f"; {what}; top-1 margins " + ", ".join(f"{m:.4g}" for m in margins)
          + f"; on {card}")
    if likelihood:
        check(all(e[1] <= BOUND for e in errs), "nni tp_likelihood: float32 "
              "candidate scores agree with float64 on the same trees")
    return ips, trees, sp, phases, launches


def gp_scores64(eng, dev):
    """The GP-scored engine's next scores, by a float64 GP engine on the
    card over the same grafted DAG, from the float32 run's state (its
    carried branch lengths and frozen q), as score_adjacent_nnis builds
    them."""
    keys = list(eng.adjacent)
    grafted, central = graft_node_pairs(
        eng.dag, [(eng.adjacent[k].parent, eng.adjacent[k].child)
                  for k in keys])
    e64 = GPEngine(eng.site_pattern, grafted, device=dev, dtype=torch.float64)
    eng._carry_branch_lengths(e64, dict(zip(eng.gp.dag.pretty_edges(),
                                            eng.gp._host(eng.gp._blc))))
    eng._carry_q(e64, keys)
    e64.populate_plvs()
    e64.compute_likelihoods()
    ll = e64.per_gpcsp_log_likelihoods()
    return {k: float(ll[c]) for k, c in zip(keys, central)}


def gp_scored_search(paths, dev, card):
    """config5's GP-scored search (gp_instance, make_gp_engine,
    take_first_branch_length, make_nni_engine gp_likelihood) on six taxa
    on the card in float32, run to completion (at most NNI_GP_ITERS
    iterations), top-1; each iteration's scores against a float64 GP
    engine from the float32 run's state within BOUND relative; no
    hand-written kernel.  A float32 GP engine refuses TF32.  Returns
    (iterations/s, the iteration's phases, torch operations on the card
    of one iteration)."""
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        nni_instance(paths, dev, PRODUCT_DTYPE, "gp_likelihood")
        refused = False
    except RuntimeError:
        refused = True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    check(refused, "nni: a float32 GP engine refuses TF32")
    inst = nni_instance(paths, dev, PRODUCT_DTYPE, "gp_likelihood")
    eng = inst.make_nni_engine("gp_likelihood")
    eng.set_top_k_score_filtering_scheme(1)
    reset_launches()
    eng.run_init()
    iters, errs, margins, loop_s, ops = 0, [], [], 0.0, None
    while iters < NNI_GP_ITERS and eng.adjacent_nni_count():
        ref = gp_scores64(eng, dev)
        # The first iteration counts the torch operations on the card (a
        # dispatch hook on every one) and is not timed.
        counting = contextlib.nullcontext() if iters else CudaOps()
        if iters == 1:
            eng.timer = SyncedPhases()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with counting:
            accepted = eng.run_main_loop()
            if accepted:
                eng.run_post_loop()
        torch.cuda.synchronize()
        if iters:
            loop_s += time.perf_counter() - t0
        else:
            ops = counting.count
        scores = {**eng.scored, **getattr(eng, "accepted_scores_this_iter",
                                          {})}
        errs.append(max(abs(scores[k] - v) / abs(v) for k, v in ref.items()))
        ranked = sorted(ref.values(), reverse=True)
        margins.append(ranked[0] - ranked[1] if len(ranked) > 1 else math.inf)
        if not accepted:
            break
        iters += 1
    no_launches("nni gp_likelihood")
    timed = max(iters - 1, 1)
    phases = {n: v * 1e3 / timed for n, v in eng.timer.totals.items()}
    ips = (iters - 1) / loop_s if iters > 1 else math.nan
    print(f"# phase 3: nni GP-scored search ({NNI_GP_TAXA} taxa, "
          f"{eng.site_pattern.pattern_count} patterns, top-1, to completion): "
          f"{iters} iterations, {ips:.3f} iterations/s (all but the first); "
          "an iteration (ms, the card synchronised at phase edges): "
          + ", ".join(
              f"{n} {ms:.1f}" for n, ms in phases.items())
          + f"; {ops} torch operations on the card in the first; scores "
          f"against float64 worst rel err {max(errs):.3e} (bound {BOUND:g}); "
          "top-1 margins (float64) " + ", ".join(f"{m:.4g}" for m in margins)
          + f"; no hand-written kernel launched; on {card}")
    check(iters > 0 and max(errs) <= BOUND, "nni: the GP-scored search's "
          "float32 scores agree with float64")
    return ips, phases, ops


def nni_path(tmp, dev, card):
    """The nni path (phase 3): config5's two searches, the faithful
    TP-likelihood search at DS1's shape and the GP-scored search on six
    taxa, and the whole-tree engine at DS1's shape with TP-likelihood and
    with parsimony scoring.  Inputs from _synthetic.write_nni_inputs: the
    seed is a random rooted tree, the alignment simulated under JC69 along
    the seed after TRUTH_NNIS random NNIs.  Returns {what: value} for
    phase 4 and the PERF.md lines."""
    ds1 = _synthetic.write_nni_inputs(
        tempfile.mkdtemp(dir=tmp), SEED, _synthetic.DS1_TAXA,
        _synthetic.DS1_SITES, _synthetic.DS1_DISTINCT_COLUMNS)
    six = _synthetic.write_nni_inputs(tempfile.mkdtemp(dir=tmp), SEED,
                                      NNI_GP_TAXA, NNI_GP_SITES)
    out = dict(faithful=faithful_search(ds1, dev, card))
    out["tp_likelihood"] = whole_tree_search(ds1, dev, "tp_likelihood", card)
    out["tp_parsimony"] = whole_tree_search(ds1, dev, "tp_parsimony", card)
    out["gp"] = gp_scored_search(six, dev, card)
    return out


def nni_kernel_times(nni, dev, card):
    """Phase 4 for the nni path: paired_ll_onchip at the whole-tree
    engine's last candidate batch (JC69, C = 1), its plain version and its
    bound; held once against the float64 plain version within BOUND."""
    _ips, trees, sp, _phases, _launches = nni["tp_likelihood"]
    model = PhyloModel(PhyloModelSpecification())
    e = TreeLikelihoodEngine(sp, model, device=dev, dtype=PRODUCT_DTYPE)
    enc = e.encode(trees)
    bl = e.branch_length_matrix(trees, enc)
    eig, rates, props, clock = e._model_ingredients({}, len(trees))
    pi, prop = prep.kernel_model(eig, props)
    P = prep.prepare_inputs(eig, rates, clock, bl)
    dst, tip, _src, edge, _mask = e._paired_tapes(enc)
    onchip = e._onchip_tape(enc)
    tips, w = e._kernel_tips, e._kernel_weights
    ops = (dst, tip, edge, P, tips, pi, prop, w)
    got = paired.paired_log_likelihoods(*ops, onchip=onchip)
    want = paired.paired_log_likelihoods_ref(
        *[x.double() if x.is_floating_point() else x for x in ops])
    err = rel_err(got, want)
    check(err <= BOUND, "nni: paired_ll_onchip at the candidate batch")
    p1 = cuda_ms(lambda: paired.paired_log_likelihoods_ref(*ops), 5)
    k1 = cuda_ms(lambda: paired.paired_log_likelihoods(*ops, onchip=onchip),
                 50)
    k2 = cuda_ms(lambda: paired.paired_log_likelihoods(*ops, onchip=onchip),
                 50)
    p2 = cuda_ms(lambda: paired.paired_log_likelihoods_ref(*ops), 5)
    fl_ll, _ = tree_flops(enc, sp, model, len(trees))
    moved = nbytes(dst, onchip.child, onchip.live_row, edge, P, tips, pi,
                   prop, w) + len(trees) * 4
    b_ms, b_by = bound(fl_ll, moved)
    print(f"# phase 4: nni paired_ll_onchip at the whole-tree engine's "
          f"candidate batch ({len(trees)} trees x {sp.num_taxa} taxa x "
          f"{sp.pattern_count} patterns, pad {e.pattern_pad}, C = 1): kernel "
          f"{(k1 + k2) / 2:.4f} ms (CUDA events around the calls), plain "
          f"{(p1 + p2) / 2:.4f} ms, bound {b_ms:.6f} ms by {b_by} "
          f"({fl_ll:,} FLOPs, {moved:,} bytes); rel err "
          f"against float64 {err:.3e}; on {card}")
    return (k1 + k2) / 2, (p1 + p2) / 2, b_ms


def central_differences(label, ref, trees, params64, bl64, grads):
    """Hold a float64 engine's gradients `grads` [B, N] at nodes 0, 13 and
    40 against central differences of its log likelihoods (h = 1e-6),
    within 1e-6 of the largest."""
    h = 1e-6
    for node in (0, 13, 40):
        step = torch.zeros_like(bl64)
        step[:, node] = h
        fd = (ref.log_likelihoods(trees, params64, bl64 + step)
              - ref.log_likelihoods(trees, params64, bl64 - step)) / (2 * h)
        fd_err = norm_err(grads[:, node], fd)
        print(f"# phase 3: {label}float64 gradient vs central difference, "
              f"node {node}: max-abs/max|g| {fd_err:.3e}")
        check(fd_err <= 1e-6, f"{label}float64 gradient matches finite "
              "differences")


def codon_workload(site="constant", batch=CODON_BATCH):
    """config6's shape: (trees, CodonSitePattern, PhyloModel, numpy
    parameters): 27 taxa over 649 codon columns drawn from 573 distinct
    ones (_synthetic.codon_alignment, seed 0), CODON_TREES random unrooted
    topologies cycled to `batch` trees, MG94 with config6's parameters
    and `site` rate categories (Weibull shape CODON_WEIBULL)."""
    coll = parse_newick_text(_synthetic.random_trees_newick(
        SEED, _synthetic.DS1_TAXA, CODON_TREES))
    aln = _synthetic.codon_alignment(SEED, coll.taxon_names,
                                     _synthetic.DS1_CODONS,
                                     _synthetic.DS1_DISTINCT_CODON_COLUMNS)
    params = dict(CODON_PARAMS)
    if site != "constant":
        params["site_model_parameters"] = np.array([CODON_WEIBULL])
    return ([coll.trees[i % CODON_TREES] for i in range(batch)],
            CodonSitePattern(aln, coll.taxon_names),
            PhyloModel(PhyloModelSpecification("MG94", site)), params)


def codon_operands(eng, trees, params, bl=None):
    """The A=64 kernels' operands from the engine's own prep (uniformized
    P, dP = Q P, float32), at the trees' branch lengths or `bl`: the LL
    wrapper's and the grad wrapper's positional arguments."""
    enc = eng.encode(trees)
    bl = eng.branch_length_matrix(trees, enc) if bl is None else bl
    eig, rates, props, clock = eng._model_ingredients(params, len(trees))
    pi, prop = prep.kernel_model(eig, props)
    P, dP = prep.prepare_inputs_grad_q(eig, rates, clock, bl,
                                       Q=eng._rate_Q(params))
    dst, tip, src, e, mask = eng._paired_tapes(enc)
    tips, w = eng._kernel_tips, eng._kernel_weights
    return ((dst, tip, e, P, tips, pi, prop, w),
            (dst, tip, src, e, mask, P, dP, tips, pi, prop, w))


def codon_flops(enc, sp, C, batch):
    """(LL, LL+gradient) FLOPs of one call over `batch` trees, counted as
    bito_tpu's config6 counts them (bench_configs.py:315-323): the
    algorithm's work over the 61 sense states and the true patterns."""
    S, A = sp.pattern_count, 61
    E = int(np.asarray(enc.edge_mask).sum(axis=1).mean())
    evolve = 2 * A * A * C * S
    fl_ll = E * evolve + (enc.num_slots - sp.num_taxa) * A * C * S \
        + 2 * A * C * S
    fl_grad = fl_ll + E * (2 * evolve + 3 * A * C * S)
    return fl_ll * batch, fl_grad * batch


def codon_parity(dev, errs):
    """Phase 2: each A=64 kernel, through its wrapper, against its float64
    plain version on the same float32 operands, at config6's shape (C = 1)
    and at MG94+Weibull4 (C = 4, CODON_C4_BATCH trees), within A64_BOUND;
    at C = 4 the grad kernel's gradients nearer to the 3xTF32 emulation
    than to one TF32 pass (codon_passes).  Records the C = 1 errors in
    `errs`; returns phase 4's work and calls: {kernel: (FLOPs, bytes,
    None)}, {kernel: (plain call, kernel call)}."""
    work, calls = {}, {}
    for site, batch in (("constant", CODON_BATCH),
                        ("weibull+4", CODON_C4_BATCH)):
        trees, sp, model, params = codon_workload(site, batch)
        eng = TreeLikelihoodEngine(sp, model, device=dev,
                                   dtype=PRODUCT_DTYPE)
        ll_ops, grad_ops = codon_operands(
            eng, trees, params_from_numpy(params, dev, PRODUCT_DTYPE))
        ll_k = paired.paired_log_likelihoods(*ll_ops)
        ll_g, g_k = paired.paired_ll_and_gradients(*grad_ops)
        torch.cuda.synchronize()
        ll_p, g_p = paired.paired_ll_and_gradients_ref(
            *[x.double() if x.is_floating_point() else x for x in grad_ops])
        e_ll, e_llg, e_g = (rel_err(ll_k, ll_p), rel_err(ll_g, ll_p),
                            norm_err(g_k, g_p))
        print(f"# phase 2: MG94 {site} (C={model.category_count}, {batch} "
              f"trees x {eng.pattern_pad} patterns): paired_ll_a64 LL rel "
              f"err {e_ll:.3e}; paired_grad_a64 LL rel err {e_llg:.3e}, "
              f"grad max-abs/max|g| {e_g:.3e} (bound {A64_BOUND:g}, plain "
              f"version in float64 on the same operands)")
        check(max(e_ll, e_llg, e_g) <= A64_BOUND,
              f"the A=64 kernels at {site}")
        if site != "constant":
            codon_passes(grad_ops, g_k)
            continue
        errs["paired_ll_a64"] = (e_ll, (ll_k.double() - ll_p).abs().max()
                                 .item())
        errs["paired_grad_a64"] = (e_g, (g_k.double() - g_p).abs().max()
                                   .item())
        work, calls = codon_timed(eng, trees, ll_ops, grad_ops)
    return work, calls


def codon_timed(eng, trees, ll_ops, grad_ops, suffix=""):
    """Phase 4's work and calls of both A=64 kernels (KERNELS' names with
    `suffix`) on `eng`'s operands `ll_ops`, `grad_ops` for `trees`:
    ({name: (FLOPs, bytes, None)}, {name: (plain call, kernel call)})."""
    enc, B = eng.encode(trees), len(trees)
    fl_ll, fl_grad = codon_flops(enc, eng.site_pattern,
                                 eng.model.category_count, B)
    ll, grad = "paired_ll_a64" + suffix, "paired_grad_a64" + suffix
    work = {ll: (fl_ll, nbytes(*ll_ops) + B * 4, None),
            grad: (fl_grad, nbytes(*grad_ops) + B * (1 + enc.num_slots) * 4,
                   None)}
    calls = {ll: (lambda: paired.paired_log_likelihoods_ref(*ll_ops),
                  lambda: paired.paired_log_likelihoods(*ll_ops)),
             grad: (lambda: paired.paired_ll_and_gradients_ref(*grad_ops),
                    lambda: paired.paired_ll_and_gradients(*grad_ops))}
    return work, calls


def codon_passes(grad_ops, g_k, trees=2):
    """Phase 2: on the first `trees` trees, the grad kernel's gradients
    `g_k` against paired.paired_ll_and_gradients_tf32 on the CPU with three
    TF32 passes and with one: nearer to three by at least 10 times."""
    cpu = ([x[:trees].cpu() for x in grad_ops[:7]]  # the per-tree operands
           + [x.cpu() for x in grad_ops[7:]])
    _, g3 = paired.paired_ll_and_gradients_tf32(*cpu)
    _, g1 = paired.paired_ll_and_gradients_tf32(*cpu, passes=1)
    g = g_k[:trees].cpu()
    d3, d1 = norm_err(g, g3), norm_err(g, g1)
    print(f"# phase 2: paired_grad_a64 against the 3xTF32 emulation "
          f"(paired.paired_ll_and_gradients_tf32, CPU) on {trees} trees: "
          f"max-abs/max|g| {d3:.3e} from three passes, {d1:.3e} from one")
    check(d3 < 0.1 * d1, "the A=64 grad kernel takes three TF32 passes")


def codon_edge_parity(dev, site="constant"):
    """Phase 2: both A=64 kernels at the edge of float32's range
    (_synthetic.disagreeing_codons: 8 taxa in cherries whose tips differ
    at all three codon positions, 64 codons, every branch one of
    CODON_EDGE_LENGTHS), MG94 with `site` rate categories (Gamma shape
    CODON_WEIBULL), finite and within A64_BOUND of their float64 plain
    versions on the same float32 operands."""
    params = dict(CODON_PARAMS)
    if site != "constant":
        params["site_model_parameters"] = np.array([CODON_WEIBULL])
    for t in CODON_EDGE_LENGTHS:
        newick, aln = _synthetic.disagreeing_codons(SEED, 4, 64, t)
        coll = parse_newick_text(newick)
        eng = TreeLikelihoodEngine(
            CodonSitePattern(aln, coll.taxon_names),
            PhyloModel(PhyloModelSpecification("MG94", site)),
            device=dev, dtype=PRODUCT_DTYPE)
        ll_ops, grad_ops = codon_operands(
            eng, coll.trees, params_from_numpy(params, dev, PRODUCT_DTYPE))
        ll_k = paired.paired_log_likelihoods(*ll_ops)
        ll_g, g_k = paired.paired_ll_and_gradients(*grad_ops)
        torch.cuda.synchronize()
        ll_p, g_p = paired.paired_ll_and_gradients_ref(
            *[x.double() if x.is_floating_point() else x for x in grad_ops])
        e_ll, e_llg, e_g = (rel_err(ll_k, ll_p), rel_err(ll_g, ll_p),
                            norm_err(g_k, g_p))
        print(f"# phase 2: A=64 kernels at the edge of float32's range "
              f"(MG94 {site}, every branch {t:g}, cherries differing at all "
              f"three codon positions, LL {float(ll_p[0]):.4f}): "
              f"paired_ll_a64 LL rel "
              f"err {e_ll:.3e}; paired_grad_a64 LL rel err {e_llg:.3e}, "
              f"grad max-abs/max|g| {e_g:.3e} (bound {A64_BOUND:g})")
        check(all(bool(torch.isfinite(x).all()) for x in (ll_k, ll_g, g_k)),
              f"the A=64 kernels' outputs are finite at branch length {t:g}"
              f" ({site})")
        check(max(e_ll, e_llg, e_g) <= A64_BOUND,
              f"the A=64 kernels at branch length {t:g} ({site})")


def codon_pernode_operands(eng, trees, params, dev):
    """The per-node functions' operands at 64 states from the engine's own
    prep (uniformized P, dP = Q P, float32): the LL's and the grad's
    positional arguments, and the tape (pernode.a64_tape)."""
    enc = eng.encode(trees)
    eig, rates, props, clock = eng._model_ingredients(params, len(trees))
    pi, prop = prep.kernel_model(eig, props)
    P, dP = prep.prepare_inputs_grad_q(
        eig, rates, clock, eng.branch_length_matrix(trees, enc),
        Q=eng._rate_Q(params))
    post, pre, root = (torch.as_tensor(x, dtype=torch.int32, device=dev)
                       for x in (enc.post_ops, enc.pre_ops, enc.root))
    mask = torch.as_tensor(enc.edge_mask, dtype=torch.float32, device=dev)
    tips, w = eng._kernel_tips, eng._kernel_weights
    tape = pernode.a64_tape(enc.post_ops, enc.root, enc.num_taxa,
                            enc.num_slots, dev, pre_ops=enc.pre_ops)
    return ((post, root, P, tips, pi, prop, w),
            (post, pre, root, mask, P, dP, tips, pi, prop, w), tape)


def codon_pernode_parity(dev, sites=("constant", "weibull+4")):
    """Phase 2: pernode_log_likelihoods and pernode_ll_and_gradients at 64
    states, which launch the paired A=64 kernels on the per-node tape,
    against their float64 plain versions on the same float32 operands, at
    config6's shape on CODON_PERNODE_BATCH trees, MG94 at each of `sites`
    (C = 1 and MG94+Weibull4, C = 4, unless given), within A64_BOUND.
    Returns the launches of each A=64 kernel."""
    launched = [0, 0]
    for site in sites:
        trees, sp, model, params = codon_workload(site, CODON_PERNODE_BATCH)
        eng = TreeLikelihoodEngine(sp, model, device=dev,
                                   dtype=PRODUCT_DTYPE)
        ll_ops, grad_ops, _ = codon_pernode_operands(
            eng, trees, params_from_numpy(params, dev, PRODUCT_DTYPE), dev)
        before = [paired.paired_ll_a64.launches,
                  paired.paired_grad_a64.launches]
        ll_k = pernode.pernode_log_likelihoods(*ll_ops)
        ll_g, g_k = pernode.pernode_ll_and_gradients(*grad_ops)
        torch.cuda.synchronize()
        counts = [paired.paired_ll_a64.launches - before[0],
                  paired.paired_grad_a64.launches - before[1]]
        ll_p, g_p = pernode.pernode_ll_and_gradients_ref(
            *[x.double() if x.is_floating_point() else x for x in grad_ops])
        e_ll, e_llg, e_g = (rel_err(ll_k, ll_p), rel_err(ll_g, ll_p),
                            norm_err(g_k, g_p))
        print(f"# phase 2: per-node functions at 64 states, MG94 {site} "
              f"(C={model.category_count}, {CODON_PERNODE_BATCH} trees x "
              f"{eng.pattern_pad} patterns): pernode_log_likelihoods LL rel "
              f"err {e_ll:.3e}; pernode_ll_and_gradients LL rel err "
              f"{e_llg:.3e}, grad max-abs/max|g| {e_g:.3e} (bound "
              f"{A64_BOUND:g}, plain versions in float64 on the same "
              f"operands); "
              f"launches of paired_ll_a64, paired_grad_a64 {counts}")
        check(counts == [1, 1], "the per-node functions at 64 states "
              "launched the A=64 kernels once each")
        check(max(e_ll, e_llg, e_g) <= A64_BOUND,
              f"the per-node functions at 64 states at {site}")
        launched = [a + b for a, b in zip(launched, counts)]
    return launched


def codon_path(dev, card, against_reference):
    """Phase 3's codon path at config6's shape: engine.log_likelihoods,
    ll_and_branch_gradients and a sweep of CODON_SWEEP branch_eval_fn
    calls over scaled branch lengths, on auto in float32.  Only the two
    A=64 kernels may launch and no scan tape call may run; the results are
    held against the same engine in float64 on the card (the uniformized
    scan tape), whose gradients are held against central differences.
    Returns what phase 4 times: (engine, trees, params, branch lengths,
    launches, the path's device memory high-water mark in bytes)."""
    trees, sp, model, params_np = codon_workload()
    eng = TreeLikelihoodEngine(sp, model, device=dev, dtype=PRODUCT_DTYPE)
    ref = TreeLikelihoodEngine(sp, model, device=dev, dtype=torch.float64)
    params = params_from_numpy(params_np, dev, PRODUCT_DTYPE)
    params64 = params_from_numpy(params_np, dev, torch.float64)
    enc = eng.encode(trees)
    bl = eng.branch_length_matrix(trees, enc)
    bl64 = bl.double()
    scales = [1.0 + 0.001 * k for k in range(CODON_SWEEP)]
    Q = eng._rate_Q(params)
    qt = float(-torch.diagonal(Q).min()) * float(bl.max())
    print(f"# phase 3: codon path: {sp.num_taxa} taxa, {sp.site_count} "
          f"codons, {sp.pattern_count} patterns (pad {eng.pattern_pad}), "
          f"{len(trees)} trees ({CODON_TREES} topologies), {enc.num_slots} "
          f"nodes, MG94 kappa 2.5 omega 0.3, C=1; largest q*t {qt:.3f} "
          f"(the uniformized series to K="
          f"{uniformized_terms(qt * max(scales))})")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with counting_scan_calls() as scan:
        ll = eng.log_likelihoods(trees, params)
        pairs = [eng.ll_and_branch_gradients(trees, params)]
        fn = eng.branch_eval_fn(trees, params)
        pairs += [fn(bl * f) for f in scales]
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launches = read_launches("codon")
    print(f"# phase 3: codon path scan tape calls {scan['calls']}")
    check(scan["calls"] == 0, "the codon path ran no scan tape call")
    ref_fn = ref.branch_eval_fn(trees, params64)
    refs = [ref.ll_and_branch_gradients(trees, params64)] + [
        ref_fn(bl64 * f) for f in scales]
    against_reference("codon", [ll], pairs, refs, bound=A64_BOUND)
    central_differences("codon ", ref, trees, params64, bl64, refs[0][1])
    return eng, trees, params, bl, launches, peak


def codon_times(run, card, pernode_launches):
    """Phase 4: the codon path's LL+gradient and LL evals/s on auto (the
    A=64 kernels) and on the float32 scan tape (TF32 off), bito_tpu's auto
    route at 64 states, and the path's memory high-water mark; the
    per-node functions at 64 states at the path's shape (their tape
    given) beside their plain versions, with phase 2's launches."""
    eng, trees, params, bl, _launches, peak = run
    ll_ops, grad_ops, tape = codon_pernode_operands(eng, trees, params,
                                                    bl.device)
    pn = {}
    for name, fn, plain, ops in (
            ("pernode_log_likelihoods", pernode.pernode_log_likelihoods,
             pernode.pernode_log_likelihoods_ref, ll_ops),
            ("pernode_ll_and_gradients", pernode.pernode_ll_and_gradients,
             pernode.pernode_ll_and_gradients_ref, grad_ops)):
        p1 = cuda_ms(lambda: plain(*ops), 3)
        k1 = cuda_ms(lambda: fn(*ops, onchip=tape), 20)
        k2 = cuda_ms(lambda: fn(*ops, onchip=tape), 20)
        p2 = cuda_ms(lambda: plain(*ops), 3)
        pn[name] = ((k1 + k2) / 2, (p1 + p2) / 2)
    print("# phase 4: per-node functions at 64 states (the A=64 kernels on "
          f"pernode.a64_tape, MG94 C=1, float32, {len(trees)} trees x "
          f"{eng.pattern_pad} patterns, CUDA events around the calls): "
          + "; ".join(f"{name} {k:.4f} ms, plain {p:.4f} ms"
                      for name, (k, p) in pn.items())
          + f"; phase 2's launches of paired_ll_a64, paired_grad_a64 "
          f"{pernode_launches}; on {card}")

    def evals_per_s(kernel, calls, make=eng.branch_eval_fn):
        eng.kernel = kernel
        f = make(trees, params)
        ms = cuda_ms(lambda: f(bl), calls)
        return f"{len(trees) / (ms / 1e3):.1f} ({ms:.4f} ms/call)"

    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is off")
    rates = {(what, kernel): evals_per_s(kernel, calls, make)
             for what, make in (("LL+gradient", eng.branch_eval_fn),
                                ("LL", eng.ll_eval_fn))
             for kernel, calls in (("auto", 10), ("scan", 3))}
    eng.kernel = "auto"
    print(f"# phase 4: end to end, config6-shaped MG94 (C=1) evals/s at "
          f"B={len(trees)}: " + "; ".join(
              f"{what} A=64 kernels (auto) {rates[what, 'auto']}, scan tape "
              f"in float32 {rates[what, 'scan']}"
              for what in ("LL+gradient", "LL"))
          + " (the scan tape with allow_tf32 False: bito_tpu's auto route "
          f"at 64 states); the codon path's device memory high-water mark "
          f"{peak / 2**30:.3f} GiB; on {card}")


# -- the codon path at 9-32 rate categories ----------------------------------
def codon_plain64(grad_ops, n):
    """The float64 plain LL+gradient version on the first `n` trees of the
    float32 operands `grad_ops` (each tree's rows depend on its own
    operands alone): (ll [n], grads [n, N])."""
    return paired.paired_ll_and_gradients_ref(
        *[x.double() if x.is_floating_point() else x
          for x in first_trees(grad_ops, n, 7)])


def codon_category_parity(dev, errs):
    """Phase 2 at CODON_CATEGORY_COUNTS rate categories (MG94+Gamma C, shape
    CODON_WEIBULL) at config6's shape: both A=64 kernels through their
    wrappers on all CODON_BATCH trees, finite, and their first
    CODON_REF_TREES trees' rows against the float64 plain version on
    those trees' float32 operands within A64_BOUND; at the trees' branch
    lengths and with every branch CATEGORY_EDGE_LENGTH long; at the edge
    of float32's range (codon_edge_parity at C); at CODON_CATEGORY_C the
    grad kernel's gradients nearer to the 3xTF32 emulation than to one
    TF32 pass (codon_passes, one tree) and the per-node functions at 64
    states (codon_pernode_parity).  Prints each count's scratch a tree
    and the trees one launch takes in the card's free memory.  Fills
    errs for the JSON line's @C16 entries; returns the per-node
    functions' launches of each A=64 kernel."""
    R = CODON_REF_TREES
    a64 = (paired.paired_ll_a64, paired.paired_grad_a64)
    for C in CODON_CATEGORY_COUNTS:
        trees, sp, model, params_np = codon_workload(f"gamma+{C}")
        eng = TreeLikelihoodEngine(sp, model, device=dev,
                                   dtype=PRODUCT_DTYPE)
        params = params_from_numpy(params_np, dev, PRODUCT_DTYPE)
        enc = eng.encode(trees)
        bl = eng.branch_length_matrix(trees, enc)
        short = torch.where(bl > 0, torch.full_like(bl, CATEGORY_EDGE_LENGTH),
                            bl)
        for label, lengths in (("branch lengths", bl), (
                f"every branch {CATEGORY_EDGE_LENGTH:g}", short)):
            ll_ops, grad_ops = codon_operands(eng, trees, params, lengths)
            M, S = ll_ops[0].shape[1], ll_ops[4].shape[-1]
            tree = paired.a64_tree_bytes(M, S, C)
            fits = paired.scratch_budget(dev) // tree
            before = [f.launches for f in a64]
            ll_k = paired.paired_log_likelihoods(*ll_ops)
            ll_g, g_k = paired.paired_ll_and_gradients(*grad_ops)
            torch.cuda.synchronize()
            ran = [f.launches - n for f, n in zip(a64, before)]
            ll_p, g_p = codon_plain64(grad_ops, R)
            e = (rel_err(ll_k[:R], ll_p), rel_err(ll_g[:R], ll_p),
                 norm_err(g_k[:R], g_p))
            finite = all(bool(torch.isfinite(x).all())
                         for x in (ll_k, ll_g, g_k))
            print(f"# phase 2: A=64 kernels at MG94+Gamma{C}, {label} "
                  f"({len(trees)} trees x {eng.pattern_pad} patterns; "
                  f"scratch {tree / 1e6:.1f} MB a tree, "
                  f"{len(trees) * tree / 1e9:.2f} GB for the batch, the "
                  f"free memory holds {fits} trees a launch; launches of "
                  f"paired_ll_a64, paired_grad_a64 {ran}): on the first {R}"
                  f" trees LL rel err {e[0]:.3e}, grad kernel's LL "
                  f"{e[1]:.3e}, grad max-abs/max|g| {e[2]:.3e} (bound "
                  f"{A64_BOUND:g}, plain version in float64 on the same "
                  "operands)")
            check(min(ran) >= 1, f"C={C} {label}: both A=64 kernels launched")
            check(finite and max(e) <= A64_BOUND,
                  f"C={C} {label}: the A=64 kernels within {A64_BOUND:g}")
            if C == CODON_CATEGORY_C and lengths is bl:
                errs["paired_ll_a64@C16"] = (
                    e[0], (ll_k[:R].double() - ll_p).abs().max().item())
                errs["paired_grad_a64@C16"] = (
                    e[2], (g_k[:R].double() - g_p).abs().max().item())
                codon_passes(grad_ops, g_k, trees=1)
            del ll_ops, grad_ops, ll_k, ll_g, g_k, ll_p, g_p
            torch.cuda.empty_cache()
        del eng
        torch.cuda.empty_cache()
        codon_edge_parity(dev, f"gamma+{C}")
    return codon_pernode_parity(dev, (f"gamma+{CODON_CATEGORY_C}",))


def codon_refs64(sp, model, trees, params_np, bl, scales, dev):
    """The float64 engine's (ll, grads) on the card (the uniformized scan
    tape) on `trees`, at branch lengths `bl` and then at `bl` times each
    of `scales`."""
    ref = TreeLikelihoodEngine(sp, model, device=dev, dtype=torch.float64)
    params64 = params_from_numpy(params_np, dev, torch.float64)
    fn = ref.branch_eval_fn(trees, params64)
    return [fn(bl.double() * f) for f in [1.0] + list(scales)]


def codon_categories_path(dev, against_reference):
    """Phase 3's codon-categories path: config6's shape at MG94+Gamma
    CODON_CATEGORY_C on auto in float32 (before, past 8 categories auto
    took the scan tape and kernel="cuda" raised): log_likelihoods, an
    ll_eval_fn call, ll_and_branch_gradients and CODON_CATEGORY_SWEEP
    branch_eval_fn calls over scaled branch lengths.  Only the two A=64
    kernels may launch (counted for the JSON line's @C16 entries) and no
    scan tape call may run; every result is finite and the first
    CODON_REF_TREES trees' are held against the float64 engine on those
    trees (codon_refs64) within A64_BOUND.  Then kernel="cuda" at 33
    categories on two trees launches both A=64 kernels (it once raised),
    held to the float64 engine the same way, and branch_eval_fn at
    CODON_WIDE_BATCH trees and the largest of CODON_CATEGORY_COUNTS runs
    on as many launches as the scratch's slices of trees need, held the
    same way.  Returns (engine, trees, float32 params, launches)."""
    C, R = CODON_CATEGORY_C, CODON_REF_TREES
    trees, sp, model, params_np = codon_workload(f"gamma+{C}")
    eng = TreeLikelihoodEngine(sp, model, device=dev, dtype=PRODUCT_DTYPE)
    check(eng._route(True) == "paired",
          f"auto takes the A=64 kernels at C={C}")
    params = params_from_numpy(params_np, dev, PRODUCT_DTYPE)
    bl = eng.branch_length_matrix(trees, eng.encode(trees))
    scales = [1.0 + 0.001 * k for k in range(1, CODON_CATEGORY_SWEEP + 1)]
    refs = codon_refs64(sp, model, trees[:R], params_np, bl[:R], scales, dev)
    torch.cuda.empty_cache()
    reset_launches()
    with counting_scan_calls() as scan:
        ll = eng.log_likelihoods(trees, params)
        ll_fn = eng.ll_eval_fn(trees, params)(bl)
        pairs = [eng.ll_and_branch_gradients(trees, params)]
        fn = eng.branch_eval_fn(trees, params)
        pairs += [fn(bl * f) for f in scales]
        torch.cuda.synchronize()
    launches = read_launches("codon-categories")
    print(f"# phase 3: codon-categories path (MG94+Gamma{C}, {len(trees)} "
          f"trees x {eng.pattern_pad} patterns) scan tape calls "
          f"{scan['calls']}")
    check(scan["calls"] == 0, "the codon-categories path ran no scan tape "
          "call")
    check(all(bool(torch.isfinite(x).all())
              for x in [ll, ll_fn] + [x for pair in pairs for x in pair]),
          "the codon-categories path's outputs are finite")
    against_reference(f"codon-categories (first {R} trees)",
                      [ll[:R], ll_fn[:R]],
                      [(x[:R], g[:R]) for x, g in pairs], refs,
                      bound=A64_BOUND)

    past = max(CODON_CATEGORY_COUNTS) + 1
    t33, sp33, m33, p33 = codon_workload(f"gamma+{past}", 2)
    e33 = TreeLikelihoodEngine(sp33, m33, device=dev, dtype=PRODUCT_DTYPE)
    check(e33._route(True) == "paired", f"auto takes the A=64 kernels at "
          f"C={past}")
    e33.kernel = "cuda"
    bl33 = e33.branch_length_matrix(t33, e33.encode(t33))
    refs33 = codon_refs64(sp33, m33, t33, p33, bl33, (), dev)
    before = [paired.paired_ll_a64.launches, paired.paired_grad_a64.launches]
    p33 = params_from_numpy(p33, dev, PRODUCT_DTYPE)
    ll33 = e33.log_likelihoods(t33, p33)
    pair33 = e33.ll_and_branch_gradients(t33, p33)
    torch.cuda.synchronize()
    ran = [paired.paired_ll_a64.launches - before[0],
           paired.paired_grad_a64.launches - before[1]]
    print(f"# phase 3: kernel='cuda' at MG94+Gamma{past}: launches of "
          f"paired_ll_a64, paired_grad_a64 {ran}")
    check(min(ran) >= 1, f"kernel='cuda' at C={past} launches both A=64 "
          "kernels")
    against_reference(f"kernel='cuda' at MG94+Gamma{past} ({len(t33)} "
                      "trees)", [ll33], [pair33], refs33, bound=A64_BOUND)

    Cw = max(CODON_CATEGORY_COUNTS)
    tw, spw, mw, pw = codon_workload(f"gamma+{Cw}", CODON_WIDE_BATCH)
    wide = TreeLikelihoodEngine(spw, mw, device=dev, dtype=PRODUCT_DTYPE)
    encw = wide.encode(tw)
    blw = wide.branch_length_matrix(tw, encw)
    refs = codon_refs64(spw, mw, tw[:R], pw, blw[:R], (), dev)
    torch.cuda.empty_cache()
    fn = wide.branch_eval_fn(tw, params_from_numpy(pw, dev, PRODUCT_DTYPE))
    tree = paired.a64_tree_bytes(wide._paired_tapes(encw)[0].shape[1],
                                 wide.pattern_pad, Cw)
    before = paired.paired_grad_a64.launches
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pair = fn(blw)
    torch.cuda.synchronize()
    print(f"# phase 3: branch_eval_fn at MG94+Gamma{Cw} on "
          f"{CODON_WIDE_BATCH} trees: {paired.paired_grad_a64.launches - before}"
          f" launch(es) of paired_grad_a64 (scratch {tree / 1e6:.1f} MB a "
          f"tree, {CODON_WIDE_BATCH * tree / 1e9:.2f} GB for the batch); "
          "device memory high-water mark "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    check(paired.paired_grad_a64.launches > before
          and all(bool(torch.isfinite(x).all()) for x in pair),
          f"branch_eval_fn at C={Cw} x {CODON_WIDE_BATCH} trees ran the A=64 "
          "grad kernel, finite")
    against_reference(f"codon-categories at C={Cw} x {CODON_WIDE_BATCH} trees "
                      f"(first {R} trees)", [], [(pair[0][:R], pair[1][:R])],
                      refs, bound=A64_BOUND)
    return eng, trees, params, launches


def codon_category_times(run, times, card):
    """Phase 4 at CODON_CATEGORY_COUNTS categories at config6's shape: each
    A=64 kernel through its wrapper beside its float32 plain version, in
    turns (plain, kernel, kernel, plain; at CODON_CATEGORY_C the JSON
    line's times from the main loop), and beside both bounds (bito_tpu's
    FLOPs, codon_flops, at 3xTF32 and at float32 FMAs); auto's
    LL+gradient call (branch_eval_fn) and the device memory high-water
    mark over it (after a reset); at CODON_CATEGORY_C its evals/s beside
    the float32 scan tape's call, which auto took before (TF32 off)."""
    eng16, trees16, params16, _ = run
    for C in CODON_CATEGORY_COUNTS:
        if C == CODON_CATEGORY_C:
            eng, trees, params = eng16, trees16, params16
        else:
            trees, sp, model, params_np = codon_workload(f"gamma+{C}")
            eng = TreeLikelihoodEngine(sp, model, device=eng16.device,
                                       dtype=PRODUCT_DTYPE)
            params = params_from_numpy(params_np, eng16.device,
                                       PRODUCT_DTYPE)
        ll_ops, grad_ops = codon_operands(eng, trees, params)
        work, calls = codon_timed(eng, trees, ll_ops, grad_ops)
        parts = []
        for name in ("paired_ll_a64", "paired_grad_a64"):
            if C == CODON_CATEGORY_C:
                k, pl = times[name + "@C16"][:2]
            else:
                plain, kernel = calls[name]
                p1, k1 = cuda_ms(plain, 1, warmup=1), cuda_ms(kernel, 10)
                k2, p2 = cuda_ms(kernel, 10), cuda_ms(plain, 1, warmup=1)
                k, pl = (k1 + k2) / 2, (p1 + p2) / 2
            tf_ms = bound(*work[name][:2], peak=PEAK_3XTF32)[0]
            fma_ms = bound(*work[name][:2])[0]
            parts.append(f"{name} {k:.4f} ms (plain {pl:.4f}; bound "
                         f"{tf_ms:.4f} at 3xTF32, {100 * tf_ms / k:.1f}% of "
                         f"it; {fma_ms:.4f} at float32 FMAs, "
                         f"{100 * fma_ms / k:.1f}%)")
        del ll_ops, grad_ops, calls
        torch.cuda.empty_cache()
        bl = eng.branch_length_matrix(trees, eng.encode(trees))
        fn = eng.branch_eval_fn(trees, params)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(lambda: fn(bl), 5)
        parts.append(f"auto's LL+gradient call (branch_eval_fn) {ms:.4f} ms "
                     f"({len(trees) / (ms / 1e3):.1f} evals/s), device "
                     "memory high-water mark "
                     f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
        if C == CODON_CATEGORY_C:
            check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is off")
            eng.kernel = "scan"
            scan = eng.branch_eval_fn(trees, params)
            s_ms = cuda_ms(lambda: scan(bl), 2, warmup=1)
            eng.kernel = "auto"
            parts.append(f"the float32 scan tape's call, auto's route before,"
                         f" {s_ms:.4f} ms ({len(trees) / (s_ms / 1e3):.1f} "
                         "evals/s)")
        print(f"# phase 4: A=64 kernels at MG94+Gamma{C} (float32, "
              f"{len(trees)} trees x {eng.pattern_pad} patterns, CUDA "
              f"events): " + "; ".join(parts) + f"; on {card}")
        del eng, fn, bl
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# The wide path: every tree kernel past 32 rate categories
# ---------------------------------------------------------------------------

# Each launcher of rows 1-6 by its name in the JSON line past 32
# categories (`<name>@C<C>`): the on-chip bodies with K categories a lane,
# the paired grad body on rows 4 and 6's tapes, the global bodies' wide
# kernels
WIDE_NAMES = {paired.paired_ll_onchip: "paired_ll_onchip",
              paired.paired_grad_onchip: "paired_grad_onchip",
              chunked.chunked_ll_onchip: "chunked_ll_onchip",
              chunked.chunked_grad_paired: "chunked_grad_paired",
              pernode.pernode_ll_onchip: "pernode_ll_onchip",
              pernode.pernode_grad_paired: "pernode_grad_paired",
              paired.paired_ll_global: "paired_ll",
              paired.paired_grad_global: "paired_grad",
              chunked.chunked_ll_global: "chunked_ll",
              chunked.chunked_grad_global: "chunked_grad",
              pernode.pernode_ll_global: "pernode_ll",
              pernode.pernode_grad_global: "pernode_grad"}
PAIRED_BODIES = (paired.paired_ll_onchip, paired.paired_ll_global,
                 paired.paired_grad_onchip, paired.paired_grad_global)


def wide_rows_timed(eng, trees, params):
    """Rows 1-6 on `eng`'s flagship operands past 32 categories: each
    wrapper, which takes the on-chip body with K categories a lane where
    its plan fits (`<row>_onchip@C<C>`, rows 4 and 6 the paired grad body,
    `<row>_paired@C<C>`), and each global body's wide kernel through its
    launcher (`<row>@C<C>`): ({name: (FLOPs, bytes, None)}, {name: (plain
    call, kernel call)}), the bytes each input read once and each output
    written once (the tapes each body reads, the matrices, tips and
    model, the LL and gradient rows)."""
    C, B = eng.model.category_count, len(trees)
    enc = eng.encode(trees)
    fl_ll, fl_grad = tree_flops(enc, eng.site_pattern, eng.model, B)
    ll_ops, grad_ops, on = paired_operands(eng, trees, params)
    c_ops, con, p_ops, pll, pon = rows_operands(eng, trees, params)
    dst, tip, src, e, mask, P, dP, tips, pi, prop, w = grad_ops
    cdst, ctip, cedge, crow, _, cP, cdP = c_ops[:7]
    post, pre, root = p_ops[:3]
    pt = pon.paired
    cll = (cdst, ctip, cedge, cP, tips, pi, prop, w)
    f_ll = nbytes(P, tips, pi, prop, w) + B * 4
    f_grad = (nbytes(P, dP, tips, pi, prop, w, mask)
              + B * (1 + enc.num_slots) * 4)
    s = f"@C{C}"
    ll = {"paired_ll_onchip": nbytes(dst, on.child, on.live_row, e),
          "chunked_ll_onchip": nbytes(cdst, con.child, con.live_row, cedge),
          "pernode_ll_onchip": nbytes(pll.post_dst, pll.child, pll.live_row,
                                      pll.post_e),
          "paired_ll": nbytes(dst, tip, e),
          "chunked_ll": nbytes(cdst, con.child, cedge),
          "pernode_ll": nbytes(post, root)}
    grad = {"paired_grad_onchip": nbytes(dst, on.child, src, e),
            "chunked_grad_paired": nbytes(cdst, con.child, cedge, crow)
            + cdst.numel() * 8,
            "pernode_grad_paired": nbytes(pt.post_dst, pt.onchip.child,
                                          pt.post_src, pt.post_e),
            "paired_grad": nbytes(dst, tip, src, e),
            "chunked_grad": nbytes(cdst, con.child, cedge, crow),
            "pernode_grad": nbytes(post, pre, root)}
    work = {k + s: (fl_ll, v + f_ll, None) for k, v in ll.items()}
    work.update({k + s: (fl_grad, v + f_grad, None)
                 for k, v in grad.items()})
    plain = {"paired_ll": lambda: paired.paired_log_likelihoods_ref(*ll_ops),
             "paired_grad": lambda: paired.paired_ll_and_gradients_ref(
                 *grad_ops),
             "chunked_ll": lambda: chunked.chunked_log_likelihoods_ref(*cll),
             "chunked_grad": lambda: chunked.chunked_ll_and_gradients_ref(
                 *c_ops),
             "pernode_ll": lambda: pernode.pernode_log_likelihoods_ref(
                 post, root, cP, tips, pi, prop, w),
             "pernode_grad": lambda: pernode.pernode_ll_and_gradients_ref(
                 *p_ops)}
    kernel = {
        "paired_ll_onchip": lambda: paired.paired_log_likelihoods(
            *ll_ops, onchip=on),
        "paired_grad_onchip": lambda: paired.paired_ll_and_gradients(
            *grad_ops, onchip=on),
        "chunked_ll_onchip": lambda: chunked.chunked_log_likelihoods(
            *cll, onchip=con),
        "chunked_grad_paired": lambda: chunked.chunked_ll_and_gradients(
            *c_ops, onchip=con),
        "pernode_ll_onchip": lambda: pernode.pernode_log_likelihoods(
            post, root, cP, tips, pi, prop, w, onchip=pll),
        "pernode_grad_paired": lambda: pernode.pernode_ll_and_gradients(
            *p_ops, onchip=pon),
        "paired_ll": lambda: paired.paired_ll_global(
            dst, tip, e, P, tips, pi, prop) @ w,
        "paired_grad": lambda: paired.finish_rows(*paired.paired_grad_global(
            dst, tip, src, e, P, dP, tips, pi, prop, w), mask, w),
        "chunked_ll": lambda: chunked.chunked_ll_global(
            cdst, ctip, cedge, cP, tips, pi, prop, child=con.child) @ w,
        "chunked_grad": lambda: chunked.finish_rows(
            *chunked.chunked_grad_global(cdst, ctip, cedge, cP, cdP, tips, pi,
                                         prop, w, child=con.child),
            crow, mask, w),
        "pernode_ll": lambda: pernode.pernode_ll_global(
            post, root, cP, tips, pi, prop) @ w,
        "pernode_grad": lambda: pernode.finish_rows(
            *pernode.pernode_grad_global(post, pre, root, cP, cdP, tips, pi,
                                         prop, w), mask, w)}
    calls = {k + s: (plain[next(r for r in WIDE_ROWS if k.startswith(r))],
                     call) for k, call in kernel.items()}
    return work, calls


def wide_parity(dev, errs):
    """Phase 2 past 32 categories: rows 1-6 at WIDE_COUNTS on the
    flagship's BATCH trees and at WIDE_SMALL on its first WIDE_REF_TREES,
    the first WIDE_REF_TREES trees' rows against the float64 plain
    versions on those trees' float32 operands within BOUND: each wrapper
    (the on-chip bodies with K categories a lane where the plan fits,
    rows 4 and 6 on the paired grad body, else the wide kernels), and
    every other body forced through its launcher (the K bodies at one
    warp at least, the global bodies' wide kernels); rows 1b-2b at
    WIDE_COUNTS and WIDE_CODON_C at config6's shape on CODON_REF_TREES
    trees against the float64 plain version within A64_BOUND.  Fills errs
    for the JSON line's @C64 and @C48 entries."""
    params = params_from_numpy(PARAMS, dev, PRODUCT_DTYPE)
    trees, sp, _ = flagship()
    R = WIDE_REF_TREES
    for C in WIDE_COUNTS + WIDE_SMALL:
        tr = trees if C in WIDE_COUNTS else trees[:R]
        eng = TreeLikelihoodEngine(sp, category_model(C), device=dev,
                                   dtype=PRODUCT_DTYPE)
        ll_ops, grad_ops, on = paired_operands(eng, tr, params)
        dst, tip, src, e, mask, P, dP, tips, pi, prop, w = grad_ops
        M, N1 = dst.shape[1], P.shape[1]
        plans = {k: paired.onchip_plan(k, rows, M, N1, C)
                 for k, rows in (("ll", on.ll_rows), ("grad", on.grad_rows))}
        forced = {k: paired.onchip_plan(k, rows, M, N1, C, ring=True)
                  for k, rows in (("ll", on.ll_rows), ("grad", on.grad_rows))}
        check(all(p is not None and p.categories_per_lane
                  == paired.lane_categories(C) for p in forced.values()),
              f"C={C}: the K bodies fit the flagship")
        hot = lambda f: [int(g is f) for g in PAIRED_BODIES]
        runs = [
            ("paired LL wrapper", lambda: (paired.paired_log_likelihoods(
                *ll_ops, onchip=on), None), hot(
                    paired.paired_ll_onchip if plans["ll"]
                    else paired.paired_ll_global)),
            ("paired grad wrapper", lambda: paired.paired_ll_and_gradients(
                *grad_ops, onchip=on), hot(
                    paired.paired_grad_onchip if plans["grad"]
                    else paired.paired_grad_global))]
        if plans["ll"] is None:
            runs.append(("paired LL on-chip body", lambda: (
                paired.paired_ll_onchip(dst, on, e, P, tips, pi, prop,
                                        forced["ll"]) @ w, None),
                hot(paired.paired_ll_onchip)))
        if plans["grad"] is None:
            runs.append(("paired grad on-chip body", lambda: (
                paired.finish_rows(*paired.paired_grad_onchip(
                    dst, on, src, e, P, dP, tips, pi, prop, w,
                    forced["grad"]), mask, w)),
                hot(paired.paired_grad_onchip)))
        runs += [("paired LL global body", lambda: (paired.paired_ll_global(
                     dst, tip, e, P, tips, pi, prop) @ w, None),
                  hot(paired.paired_ll_global)),
                 ("paired grad global body", lambda: paired.finish_rows(
                     *paired.paired_grad_global(dst, tip, src, e, P, dP,
                                                tips, pi, prop, w), mask, w),
                  hot(paired.paired_grad_global))]
        ll_p, g_p = plain64(first_trees(grad_ops, R, 7), step=10)
        c_ops, con, p_ops, pll, pon = rows_operands(eng, tr, params)
        refs = dict(zip(("chunked", "pernode"), rows_plain64(
            first_trees(c_ops, R, 7), first_trees(p_ops, R, 6), step=10)))
        refs["paired"] = (ll_p, g_p)
        rows, routes = rows_runs(c_ops, con, p_ops, pll, pon, True)
        parts, worst = [], 0.0
        for name, call, want in (
                [(n, c, ("paired", PAIRED_BODIES, want)) for n, c, want in runs]
                + [(n, c, (fam, ROWS_BODIES, want))
                   for n, c, fam, want in rows]):
            family, bodies, want = want
            before = [f.launches for f in bodies]
            ll_k, g_k = call()
            torch.cuda.synchronize()
            ran = [f.launches - n for f, n in zip(bodies, before)]
            check(ran == want, f"C={C}: {name} launched {want}, not {ran}")
            ll_ref, g_ref = refs[family]
            found = [rel_err(ll_k[:R], ll_ref)] + (
                [] if g_k is None else [norm_err(g_k[:R], g_ref)])
            x, ref = (ll_k[:R], ll_ref) if g_k is None else (g_k[:R], g_ref)
            check(bool(torch.isfinite(ll_k).all()) and (
                g_k is None or bool(torch.isfinite(g_k).all()))
                and max(found) <= BOUND, f"C={C}: {name} within {BOUND:g}")
            worst = max([worst] + found)
            launcher = bodies[want.index(1)]
            parts.append(f"{name} " + "/".join(f"{v:.3e}" for v in found))
            if C == WIDE_C:
                errs[f"{WIDE_NAMES[launcher]}@C{C}"] = (
                    rel_err(x, ref) if g_k is None else norm_err(x, ref),
                    (x.double() - ref).abs().max().item())
        print(f"# phase 2: rows 1-6 at C={C} ({paired.lane_categories(C)} "
              f"categories a lane of 32; {len(tr)} trees x {eng.pattern_pad} "
              f"patterns, the first {R} held; plans: paired LL "
              f"{body_of(plans['ll'])}, grad {body_of(plans['grad'])}, "
              f"{route_line(routes)}), LL rel err (/ grad max-abs/max|g|) "
              "against the float64 plain version: "
              + ", ".join(parts) + f" (bound {BOUND:g}; {worst:.3e} at most)")
        del eng, ll_ops, grad_ops, on, c_ops, con, p_ops, pll, pon, refs
        del runs, rows, ll_p, g_p
        torch.cuda.empty_cache()
    a64 = (paired.paired_ll_a64, paired.paired_grad_a64)
    for C in sorted(WIDE_COUNTS + (WIDE_CODON_C,)):
        ctrees, csp, model, params_np = codon_workload(f"gamma+{C}",
                                                       CODON_REF_TREES)
        eng = TreeLikelihoodEngine(csp, model, device=dev,
                                   dtype=PRODUCT_DTYPE)
        ll_ops, grad_ops = codon_operands(
            eng, ctrees, params_from_numpy(params_np, dev, PRODUCT_DTYPE))
        before = [f.launches for f in a64]
        ll_k = paired.paired_log_likelihoods(*ll_ops)
        ll_g, g_k = paired.paired_ll_and_gradients(*grad_ops)
        torch.cuda.synchronize()
        ran = [f.launches - n for f, n in zip(a64, before)]
        ll_p, g_p = codon_plain64(grad_ops, len(ctrees))
        e = (rel_err(ll_k, ll_p), rel_err(ll_g, ll_p), norm_err(g_k, g_p))
        finite = all(bool(torch.isfinite(x).all()) for x in (ll_k, ll_g, g_k))
        M, S = ll_ops[0].shape[1], ll_ops[4].shape[-1]
        print(f"# phase 2: A=64 kernels at MG94+Gamma{C} ({len(ctrees)} "
              f"trees x {eng.pattern_pad} patterns; scratch "
              f"{paired.a64_tree_bytes(M, S, C) / 1e6:.1f} MB a tree; "
              f"launches {ran}): LL rel err {e[0]:.3e}, grad kernel's LL "
              f"{e[1]:.3e}, grad max-abs/max|g| {e[2]:.3e} (bound "
              f"{A64_BOUND:g}, plain version in float64 on the same "
              "operands)")
        check(min(ran) >= 1 and finite and max(e) <= A64_BOUND,
              f"C={C}: the A=64 kernels within {A64_BOUND:g}")
        if C == WIDE_CODON_C:
            errs[f"paired_ll_a64@C{C}"] = (
                e[0], (ll_k.double() - ll_p).abs().max().item())
            errs[f"paired_grad_a64@C{C}"] = (
                e[2], (g_k.double() - g_p).abs().max().item())
        del eng, ll_ops, grad_ops, ll_k, ll_g, g_k, ll_p, g_p
        torch.cuda.empty_cache()


def wide_path(dev, against_reference):
    """The wide path (phase 3): the flagship at GTR+Gamma WIDE_C, where
    auto once took the scan tape and kernel="chunked" and the per-node
    functions raised: log_likelihoods, ll_and_branch_gradients
    and WIDE_SWEEP branch_eval_fn calls over scaled branch lengths on
    auto, the same with kernel="chunked", and the per-node functions on
    the same trees and lengths (the global bodies' wide kernels, counted
    for the JSON line's @C64 entries); then config6's shape at MG94+Gamma
    WIDE_CODON_C on auto (log_likelihoods and ll_and_branch_gradients,
    the A=64 kernels over the launchers' slices of trees, counted for the
    @C48 entries).  No scan tape call may run; every result is finite and
    the first WIDE_REF_TREES (flagship) or CODON_REF_TREES (codon) trees'
    are held against the float64 engine on those trees.  Returns (engine,
    trees, float32 params, codon engine, codon trees, codon float32
    params, launches)."""
    R = WIDE_REF_TREES
    trees, sp, _ = flagship()
    model = category_model(WIDE_C)
    eng = TreeLikelihoodEngine(sp, model, device=dev, dtype=PRODUCT_DTYPE)
    check(eng._route(True) == "paired",
          f"auto takes the paired kernels at C={WIDE_C}")
    params = params_from_numpy(PARAMS, dev, PRODUCT_DTYPE)
    enc = eng.encode(trees)
    bl = eng.branch_length_matrix(trees, enc)
    scales = [1.0 + 0.001 * k for k in range(1, WIDE_SWEEP + 1)]
    refs = codon_refs64(sp, model, trees[:R], PARAMS, bl[:R], scales, dev)
    torch.cuda.empty_cache()
    eig, rates, props, clock = eng._model_ingredients(params, len(trees))
    pi, prop = prep.kernel_model(eig, props)
    post, pre, root = (torch.as_tensor(x, dtype=torch.int32, device=dev)
                       for x in (enc.post_ops, enc.pre_ops, enc.root))
    mask = torch.as_tensor(enc.edge_mask, dtype=torch.float32, device=dev)
    pll = pernode.ll_tape(enc.post_ops, enc.root, enc.num_taxa,
                          enc.num_slots, dev)
    pon = pernode.onchip_tape(enc.post_ops, enc.pre_ops, enc.root,
                              enc.num_taxa, enc.num_slots, dev)
    tips, w = eng._kernel_tips, eng._kernel_weights
    results = {}
    reset_launches()
    t0 = time.perf_counter()
    with counting_scan_calls() as scan:
        for kernel in ("auto", "chunked"):
            eng.kernel = kernel
            ll = eng.log_likelihoods(trees, params)
            pairs = [eng.ll_and_branch_gradients(trees, params)]
            fn = eng.branch_eval_fn(trees, params)
            results[kernel] = ([ll], pairs + [fn(bl * f) for f in scales])
        eng.kernel = "auto"
        P, _ = prep.prepare_inputs_grad(eig, rates, clock, bl)
        ll = pernode.pernode_log_likelihoods(post, root, P, tips, pi, prop,
                                             w, onchip=pll)
        pairs = []
        for f in [1.0] + scales:
            Pk, dPk = prep.prepare_inputs_grad(eig, rates, clock, bl * f)
            pairs.append(pernode.pernode_ll_and_gradients(
                post, pre, root, mask, Pk, dPk, tips, pi, prop, w,
                onchip=pon))
        results["per-node functions"] = ([ll], pairs)
        torch.cuda.synchronize()
    launches = read_launches("wide")
    print(f"# phase 3: wide path (GTR+Gamma{WIDE_C}, {len(trees)} trees x "
          f"{eng.pattern_pad} patterns) in {time.perf_counter() - t0:.1f} s; "
          f"scan tape calls {scan['calls']}")
    check(scan["calls"] == 0, "the wide path ran no scan tape call")
    for label, (lls, pairs) in results.items():
        check(all(bool(torch.isfinite(x).all())
                  for x in lls + [x for pair in pairs for x in pair]),
              f"the wide path's {label} outputs are finite")
        against_reference(f"wide, {label} (first {R} trees)",
                          [x[:R] for x in lls],
                          [(x[:R], g[:R]) for x, g in pairs], refs)
    del results, refs, pairs, P, pon, pll
    torch.cuda.empty_cache()
    launches.update(wide_large_path(dev, against_reference))

    Rc = CODON_REF_TREES
    ctrees, csp, cmodel, cparams_np = codon_workload(f"gamma+{WIDE_CODON_C}")
    ceng = TreeLikelihoodEngine(csp, cmodel, device=dev, dtype=PRODUCT_DTYPE)
    check(ceng._route(True) == "paired",
          f"auto takes the A=64 kernels at C={WIDE_CODON_C}")
    cparams = params_from_numpy(cparams_np, dev, PRODUCT_DTYPE)
    cenc = ceng.encode(ctrees)
    cbl = ceng.branch_length_matrix(ctrees, cenc)
    crefs = codon_refs64(csp, cmodel, ctrees[:Rc], cparams_np, cbl[:Rc], (),
                         dev)
    tree = paired.a64_tree_bytes(ceng._paired_tapes(cenc)[0].shape[1],
                                 ceng.pattern_pad, WIDE_CODON_C)
    torch.cuda.empty_cache()
    reset_launches()
    t0 = time.perf_counter()
    with counting_scan_calls() as scan:
        ll = ceng.log_likelihoods(ctrees, cparams)
        pair = ceng.ll_and_branch_gradients(ctrees, cparams)
        torch.cuda.synchronize()
    launches.update(read_launches("wide-codon"))
    print(f"# phase 3: wide path, codon (MG94+Gamma{WIDE_CODON_C}, "
          f"{len(ctrees)} trees x {ceng.pattern_pad} patterns; scratch "
          f"{tree / 1e6:.1f} MB a tree, {len(ctrees) * tree / 1e9:.2f} GB "
          f"for the batch) in {time.perf_counter() - t0:.1f} s; scan tape "
          f"calls {scan['calls']}")
    check(scan["calls"] == 0, "the wide codon path ran no scan tape call")
    check(all(bool(torch.isfinite(x).all()) for x in (ll,) + tuple(pair)),
          "the wide codon path's outputs are finite")
    against_reference(f"wide, codon auto (first {Rc} trees)", [ll[:Rc]],
                      [(pair[0][:Rc], pair[1][:Rc])], crefs,
                      bound=A64_BOUND)
    return eng, trees, params, ceng, ctrees, cparams, launches


def wide_large_path(dev, against_reference):
    """The wide-large path (phase 3): the large path's 921-taxon trees at
    GTR+Gamma WIDE_C, whose rows leave no warp of an on-chip body room, on
    auto, kernel="chunked" and the per-node functions (log likelihoods,
    LL and gradients, and one call at scaled branch lengths each): the
    global bodies' wide kernels, counted for the JSON line's @C64 wide
    entries, held against the float64 engine.  Returns the launches."""
    ltrees, lsp, _ = large_trees()
    model = category_model(WIDE_C)
    eng = TreeLikelihoodEngine(lsp, model, device=dev, dtype=PRODUCT_DTYPE)
    ref = TreeLikelihoodEngine(lsp, model, device=dev, dtype=torch.float64)
    ref.kernel = "scan"
    params = params_from_numpy(PARAMS, dev, PRODUCT_DTYPE)
    params64 = params_from_numpy(PARAMS, dev, torch.float64)
    enc = eng.encode(ltrees)
    bl = eng.branch_length_matrix(ltrees, enc)
    refs = [ref.ll_and_branch_gradients(ltrees, params64),
            ref.branch_eval_fn(ltrees, params64)(bl.double() * 1.001)]
    del ref
    eig, rates, props, clock = eng._model_ingredients(params, len(ltrees))
    pi, prop = prep.kernel_model(eig, props)
    post, pre, root = (torch.as_tensor(x, dtype=torch.int32, device=dev)
                       for x in (enc.post_ops, enc.pre_ops, enc.root))
    mask = torch.as_tensor(enc.edge_mask, dtype=torch.float32, device=dev)
    pll = pernode.ll_tape(enc.post_ops, enc.root, enc.num_taxa,
                          enc.num_slots, dev)
    pon = pernode.onchip_tape(enc.post_ops, enc.pre_ops, enc.root,
                              enc.num_taxa, enc.num_slots, dev)
    tips, w = eng._kernel_tips, eng._kernel_weights
    on = eng._onchip_tape(enc)
    M, N1 = eng._paired_tapes(enc)[0].shape[1], enc.num_slots + 1
    check(paired.onchip_plan("ll", on.ll_rows, M, N1, WIDE_C, ring=True)
          is None and paired.onchip_plan("grad", on.grad_rows, M, N1, WIDE_C,
                                         ring=True) is None,
          "no warp of the K bodies fits the 921-taxon trees")
    results = {}
    reset_launches()
    t0 = time.perf_counter()
    for kernel in ("auto", "chunked"):
        eng.kernel = kernel
        results[kernel] = ([eng.log_likelihoods(ltrees, params)],
                           [eng.ll_and_branch_gradients(ltrees, params),
                            eng.branch_eval_fn(ltrees, params)(bl * 1.001)])
    eng.kernel = "auto"
    P, _ = prep.prepare_inputs_grad(eig, rates, clock, bl)
    pairs = []
    for f in (1.0, 1.001):
        Pk, dPk = prep.prepare_inputs_grad(eig, rates, clock, bl * f)
        pairs.append(pernode.pernode_ll_and_gradients(
            post, pre, root, mask, Pk, dPk, tips, pi, prop, w, onchip=pon))
    results["per-node functions"] = ([pernode.pernode_log_likelihoods(
        post, root, P, tips, pi, prop, w, onchip=pll)], pairs)
    torch.cuda.synchronize()
    launches = read_launches("wide-large")
    print(f"# phase 3: wide-large path (GTR+Gamma{WIDE_C}, {len(ltrees)} "
          f"trees of {enc.num_taxa} taxa x {eng.pattern_pad} patterns) in "
          f"{time.perf_counter() - t0:.1f} s")
    for label, (lls, pairs) in results.items():
        against_reference(f"wide-large, {label}", lls, pairs, refs)
    return launches


def in_turns(plain, kernel, reps=10):
    """(kernel ms, plain ms): plain, kernel, kernel, plain, CUDA events,
    `reps` kernel calls a turn after 3, one plain call after one."""
    p1, k1 = cuda_ms(plain, 1, warmup=1), cuda_ms(kernel, reps)
    k2, p2 = cuda_ms(kernel, reps), cuda_ms(plain, 1, warmup=1)
    return (k1 + k2) / 2, (p1 + p2) / 2


def wide_codon_timed(eng, trees, params):
    """Rows 1b-2b's work and calls (codon_timed) on the first
    WIDE_CODON_TREES of `trees`, named `<kernel>@C<C>`."""
    sub = trees[:WIDE_CODON_TREES]
    return codon_timed(eng, sub, *codon_operands(eng, sub, params),
                       suffix=f"@C{eng.model.category_count}")


# Phase 4's counts of the K bodies by warps a block (K = 2 and 4)
K_WARPS_COUNTS = (64, 128)


def k_warps_times(sp, trees, params, dev, card):
    """Phase 4, the evidence for paired.K_MIN_WARPS: at K_WARPS_COUNTS on
    the flagship, the on-chip grad and LL bodies with K categories a lane
    at every block of 1 warp up to their plans' (forced plans), beside
    the paired, chunked and per-node grad kernels' and LL kernels' wide
    kernels on the same operands; CUDA events, 5 calls after one."""
    for C in K_WARPS_COUNTS:
        eng = TreeLikelihoodEngine(sp, category_model(C), device=dev,
                                   dtype=PRODUCT_DTYPE)
        work, calls = wide_rows_timed(eng, trees, params)
        _, grad_ops, on = paired_operands(eng, trees, params)
        dst, tip, src, e, mask, P, dP, tips, pi, prop, w = grad_ops
        M, N1 = dst.shape[1], P.shape[1]
        parts = []
        for kernel, rows in (("grad", on.grad_rows), ("ll", on.ll_rows)):
            top = paired.onchip_plan(kernel, rows, M, N1, C, ring=True)
            for cols in range(1, top.cols + 1):
                plan = dataclasses.replace(top, cols=cols, smem=(
                    paired.smem_bytes(kernel, rows, M, N1, C, cols, True)))
                call = (partial(paired.paired_grad_onchip, dst, on, src, e, P,
                                dP, tips, pi, prop, w, plan)
                        if kernel == "grad" else
                        partial(paired.paired_ll_onchip, dst, on, e, P, tips,
                                pi, prop, plan))
                parts.append(f"{kernel} {cols} warps "
                             f"{cuda_ms(call, 5, warmup=1):.4f}")
        for row in WIDE_ROWS:
            parts.append(f"{row} wide kernel "
                         f"{cuda_ms(calls[f'{row}@C{C}'][1], 5, warmup=1):.4f}")
        print(f"# phase 4: the K bodies by warps a block at GTR+Gamma{C} (K = "
              f"{paired.lane_categories(C)}; the plans take "
              f"{body_of(paired.onchip_plan('grad', on.grad_rows, M, N1, C))}"
              f" grad, K_MIN_WARPS {paired.K_MIN_WARPS}; float32, {BATCH} "
              f"trees x {eng.pattern_pad} patterns, ms, CUDA events): "
              + ", ".join(parts) + f"; on {card}")
        del eng, work, calls, grad_ops, on
        torch.cuda.empty_cache()


def wide_times(run, times, card):
    """Phase 4 at WIDE_TIMED categories: rows 1-6 through their wrappers
    on the flagship (BATCH trees; the wide kernels) and rows 1b-2b on
    WIDE_CODON_TREES trees of config6's shape, each beside its float32
    plain version and its bound (rows 1b-2b both bounds), in turns (at
    WIDE_C and WIDE_CODON_C the JSON line's times from the main loop);
    at each count the LL+gradient call (branch_eval_fn) of auto, of
    kernel="chunked" (4 states) and of the scan tape, the route auto once
    took past 32, and the device memory high-water mark of auto's
    call; at WIDE_CODON_C also the A=64 grad kernel on the path's whole
    batch (CODON_BATCH trees: on WIDE_CODON_TREES the grid is 1.2 waves
    of the card's SMs)."""
    eng64, trees, params, ceng, ctrees, cparams, _ = run
    dev = eng64.device
    for C in WIDE_TIMED:
        e = eng64 if C == WIDE_C else TreeLikelihoodEngine(
            eng64.site_pattern, category_model(C), device=dev,
            dtype=PRODUCT_DTYPE)
        work, calls = wide_rows_timed(e, trees, params)
        parts = []
        for row in WIDE_ROWS:  # the wrapper's K body, then the wide kernel
            body = next(k for k in calls if k.startswith(row)
                        and k != f"{row}@C{C}")
            wide = f"{row}@C{C}"
            if C == WIDE_C:
                (k, pl), kw = times[body][:2], times[wide][0]
            else:
                plain, kernel = calls[body]
                p1, k1 = cuda_ms(plain, 1, warmup=1), cuda_ms(kernel, 10)
                w1, w2 = cuda_ms(calls[wide][1], 10), cuda_ms(calls[wide][1],
                                                              10)
                k2, p2 = cuda_ms(kernel, 10), cuda_ms(plain, 1, warmup=1)
                k, pl, kw = (k1 + k2) / 2, (p1 + p2) / 2, (w1 + w2) / 2
            b_ms, b_by = bound(*work[body][:2])
            bw_ms = bound(*work[wide][:2])[0]
            parts.append(f"{body.split('@')[0]} {k:.4f} ms (bound "
                         f"{b_ms:.4f} by {b_by}, {100 * b_ms / k:.1f}%), "
                         f"wide kernel {kw:.4f} ms ({100 * bw_ms / kw:.1f}%; "
                         f"{kw / k:.2f}x), plain {pl:.4f}")
        del calls
        torch.cuda.empty_cache()
        bl = e.branch_length_matrix(trees, e.encode(trees))
        for kernel, reps in (("auto", 5), ("chunked", 5), ("scan", 2)):
            e.kernel = kernel
            f = e.branch_eval_fn(trees, params)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ms = cuda_ms(lambda: f(bl), reps, warmup=1)
            peak = torch.cuda.max_memory_allocated() / 2**30
            parts.append(f"{kernel} call {ms:.4f} ms ({BATCH / (ms / 1e3):.1f}"
                         f" evals/s, high-water {peak:.3f} GiB)")
        e.kernel = "auto"
        print(f"# phase 4: rows 1-6 at GTR+Gamma{C} ({paired.lane_categories(C)}"
              f" categories a lane of 32: each wrapper's on-chip K body beside"
              f" the global body's wide kernel; float32, {BATCH} trees x "
              f"{e.pattern_pad} patterns, CUDA events): "
              + "; ".join(parts) + f"; on {card}")
        del e, bl, f
        torch.cuda.empty_cache()
    k_warps_times(eng64.site_pattern, trees, params, dev, card)
    for C in WIDE_TIMED:
        if C == WIDE_CODON_C:
            e, tr, prm = ceng, ctrees[:WIDE_CODON_TREES], cparams
        else:
            tr, csp, model, params_np = codon_workload(f"gamma+{C}",
                                                       WIDE_CODON_TREES)
            e = TreeLikelihoodEngine(csp, model, device=dev,
                                     dtype=PRODUCT_DTYPE)
            prm = params_from_numpy(params_np, dev, PRODUCT_DTYPE)
        work, calls = wide_codon_timed(e, tr, prm)
        parts = []
        for name in ("paired_ll_a64", "paired_grad_a64"):
            key = f"{name}@C{C}"
            k, pl = (times[key][:2] if C == WIDE_CODON_C
                     else in_turns(*calls[key]))
            tf_ms = bound(*work[key][:2], peak=PEAK_3XTF32)[0]
            fma_ms = bound(*work[key][:2])[0]
            parts.append(f"{name} {k:.4f} ms (plain {pl:.4f}; bound "
                         f"{tf_ms:.4f} at 3xTF32, {100 * tf_ms / k:.1f}%; "
                         f"{fma_ms:.4f} at float32 FMAs, "
                         f"{100 * fma_ms / k:.1f}%)")
        del calls
        torch.cuda.empty_cache()
        if C == WIDE_CODON_C:  # the path's whole batch: the grid's waves
            ll_ops, grad_ops = codon_operands(ceng, ctrees, cparams)
            ms = cuda_ms(lambda: paired.paired_ll_and_gradients(*grad_ops),
                         3, warmup=1)
            parts.append(f"paired_grad_a64 on the path's {len(ctrees)} trees "
                         f"{ms:.4f} ms")
            del ll_ops, grad_ops
            torch.cuda.empty_cache()
        bl = e.branch_length_matrix(tr, e.encode(tr))
        check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is off")
        for kernel, reps in (("auto", 3), ("scan", 1)):
            e.kernel = kernel
            f = e.branch_eval_fn(tr, prm)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ms = cuda_ms(lambda: f(bl), reps, warmup=1)
            peak = torch.cuda.max_memory_allocated() / 2**30
            parts.append(f"{kernel} call {ms:.4f} ms ({len(tr) / (ms / 1e3):.1f}"
                         f" evals/s, high-water {peak:.3f} GiB)")
        e.kernel = "auto"
        print(f"# phase 4: A=64 kernels at MG94+Gamma{C} (float32, {len(tr)} "
              f"trees x {e.pattern_pad} patterns, CUDA events): "
              + "; ".join(parts) + f"; on {card}")
        del e, bl, f
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# The dist path: the pattern-sharded engines on two ranks of one card
# ---------------------------------------------------------------------------
DIST_RANKS = 2
DIST_STALL_S, DIST_HARD_S = 120, 600  # the launcher's stall and hard limits
DIST_REPS = 10  # CUDA-event calls a timing on each rank
DIST_VBPI_STEPS = 2  # the sharded trainer's timed steps, after a warm-up
GP_DIST_BOUND = 1e-9  # tests/test_dist.py:179-180
LEVELED_BOUND = 1e-10
DIST_EXPECT = {  # the route's kernels on the dist path
    "auto": ("paired_ll_onchip", "paired_grad_onchip", "transition_prep"),
    "chunked": ("chunked_ll_onchip", "chunked_grad_onchip"),
    "codon": ("paired_ll_a64", "paired_grad_a64")}


def rank_launches(label, expect):
    """{kernel: launches} on this rank since reset_launches(), after
    checking that the kernels `expect` launched and no other did."""
    counts = {name: spec["wrapper"].launches for name, spec in KERNELS.items()}
    launchers = {KERNELS[name]["wrapper"] for name in expect}
    for name, n in counts.items():
        if name in expect:
            check(n > 0, f"dist {label}: {name} launched")
        elif KERNELS[name]["wrapper"] not in launchers:  # not an alias
            check(n == 0, f"dist {label}: {name} did not launch")
    return {name: counts[name] for name in expect}


def same_on_every_rank(label, *tensors):
    """Check that every rank holds rank 0's values of `tensors` (the whole
    alignment's results, not a shard's partial sums)."""
    for t in tensors:
        r0 = t.detach().clone().contiguous()
        dist_mesh.replicate(r0)
        check(torch.equal(r0, t), f"dist {label}: every rank holds rank "
                                  "0's values")


@contextlib.contextmanager
def all_reduce_clock():
    """Time every dist.mesh.all_reduce_sum while the block runs: yields
    [seconds, calls], the card synchronised before each all_reduce (so
    that none is charged the kernels before it) and after it."""
    real, spent = dist_mesh.all_reduce_sum, [0.0, 0]

    def timed(t, group):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(t, group)
        torch.cuda.synchronize()
        spent[0] += time.perf_counter() - t0
        spent[1] += 1
        return out

    dist_mesh.all_reduce_sum = timed
    try:
        yield spent
    finally:
        dist_mesh.all_reduce_sum = real


def sharded_ms(fn, reps=DIST_REPS):
    """(ms a call of `fn` on this rank, the all_reduces' share of it): a
    warm-up call and a barrier, then a host clock over `reps` calls, the
    card synchronised at both ends and around each all_reduce."""
    fn()
    torch.distributed.barrier()
    torch.cuda.synchronize()
    with all_reduce_clock() as spent:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    return total * 1e3 / reps, spent[0] / total


def dist_route(label, kernel, sharded, whole, trees, params, refs, bound):
    """One route of a sharded engine on this rank: its LL and LL+gradient
    calls held to the float64 references `refs` within `bound` (LL
    relative, gradients max-abs over max |g|, chip_smoke's measures) and
    set beside the unsharded float32 engine `whole`; its launches; ms a
    call on this rank (CUDA events), the unsharded call's, the two
    all_reduces' alone, and each kernel wrapper's on this rank's
    operands.  Every timing starts after a barrier, so the ranks start
    together."""
    sharded.kernel = whole.kernel = kernel
    ll_ref, g_ref = refs
    reset_launches()
    ll = sharded.log_likelihoods(trees, params)
    ll2, g = sharded.ll_and_branch_gradients(trees, params)
    torch.cuda.synchronize()
    launches = rank_launches(label, DIST_EXPECT[label])
    same_on_every_rank(label, ll, ll2, g)
    errs = (rel_err(ll, ll_ref), rel_err(ll2, ll_ref), norm_err(g, g_ref))
    check(max(errs) <= bound, f"dist {label}: within {bound:g} of float64")
    w_ll = whole.log_likelihoods(trees, params)
    w_ll2, w_g = whole.ll_and_branch_gradients(trees, params)
    vs_whole = ((ll - w_ll).abs().max().item(),
                (g - w_g).abs().max().item())
    enc = sharded.encode(trees)
    bl = sharded.branch_length_matrix(trees, enc)
    fn, ll_fn = (sharded.branch_eval_fn(trees, params),
                 sharded.ll_eval_fn(trees, params))
    w_fn = whole.branch_eval_fn(trees, params)
    times = {}
    times["call"], times["all_reduce_share"] = sharded_ms(lambda: fn(bl))
    times["ll_call"], times["ll_all_reduce_share"] = sharded_ms(
        lambda: ll_fn(bl))
    torch.distributed.barrier()
    times["unsharded_call"] = cuda_ms(lambda: w_fn(bl), DIST_REPS)
    eig, rates, props, clock = sharded._model_ingredients(params, len(trees))
    pi, prop = prep.kernel_model(eig, props)
    ops = (sharded._kernel_tips, pi, prop, sharded._kernel_weights)
    torch.distributed.barrier()
    if label == "chunked":
        dst, tip, e, row, mask = sharded._chunked_tapes(enc)
        onchip = sharded._chunked_onchip_tape(enc)
        P, dP = prep.prepare_inputs_grad(eig, rates, clock, bl)
        times["ll_kernel"] = cuda_ms(lambda: chunked.chunked_log_likelihoods(
            dst, tip, e, P, *ops, onchip=onchip), DIST_REPS)
        times["grad_kernel"] = cuda_ms(
            lambda: chunked.chunked_ll_and_gradients(
                dst, tip, e, row, mask, P, dP, *ops, onchip=onchip),
            DIST_REPS)
    else:
        dst, tip, src, e, mask = sharded._paired_tapes(enc)
        onchip = sharded._onchip_tape(enc)
        Q = sharded._rate_Q(params)
        P, dP = prep.prepare_inputs_grad_q(eig, rates, clock, bl, Q=Q)
        times["ll_kernel"] = cuda_ms(lambda: paired.paired_log_likelihoods(
            dst, tip, e, P, *ops, onchip=onchip), DIST_REPS)
        times["grad_kernel"] = cuda_ms(
            lambda: paired.paired_ll_and_gradients(
                dst, tip, src, e, mask, P, dP, *ops, onchip=onchip),
            DIST_REPS)
    print(f"# dist {label}: rank {sharded.pattern_shard.rank} of "
          f"{sharded.pattern_shard.size}, {sharded.pattern_pad} of "
          f"{sharded.pattern_shard.total} patterns; LL rel err "
          f"{max(errs[:2]):.3e}, grad max-abs/max|g| {errs[2]:.3e} against "
          f"float64 unsharded (bound {bound:g}); from the unsharded float32 "
          f"kernels: LL {vs_whole[0]:.3e}, grad {vs_whole[1]:.3e} (max "
          f"abs); launches {launches}; ms a call on this rank: "
          + ", ".join(f"{k} {v:.4f}" for k, v in times.items()), flush=True)
    return dict(errs=errs, vs_whole=vs_whole, launches=launches, times=times)


def dist_gp(dev, tmp):
    """config3's shape in float64 on this rank: the log marginal and
    per-PCSP LLs after populate + likelihoods, and the branch lengths
    after one optimize_branch_lengths_once, sharded against unsharded
    within GP_DIST_BOUND; the same branch lengths on every rank.  The
    branches past the bound, if any, are counted and printed."""
    nwk, fasta = gp_files(tmp)
    runs = []
    for shard in (False, True):
        inst = gp_instance(device=dev, dtype=torch.float64)
        inst.read_fasta_file(fasta)
        inst.read_newick_file(nwk)
        inst.make_dag()
        inst.make_gp_engine()
        if shard:
            inst.get_gp_engine().shard_patterns()
        inst.populate_plvs()
        inst.compute_likelihoods()
        out = dict(marginal=inst.get_log_marginal_likelihood(),
                   pcsp=inst.get_per_gpcsp_log_likelihoods())
        torch.distributed.barrier()
        torch.cuda.synchronize()
        with all_reduce_clock() as spent:
            t0 = time.perf_counter()
            inst.optimize_branch_lengths_once()
            torch.cuda.synchronize()
            out["sweep_s"] = time.perf_counter() - t0
        out["all_reduces"] = spent
        out["bl"] = inst.get_branch_lengths()
        inst.populate_plvs()
        inst.compute_likelihoods()
        out["marginal_after"] = inst.get_log_marginal_likelihood()
        runs.append(out)
    whole, sharded = runs
    errs = (abs(sharded["marginal"] - whole["marginal"]),
            float(np.abs(sharded["pcsp"] - whole["pcsp"]).max()),
            abs(sharded["marginal_after"] - whole["marginal_after"]))
    bl_err = np.abs(sharded["bl"] - whole["bl"])
    past = bl_err > GP_DIST_BOUND
    same_on_every_rank("gp", torch.as_tensor(sharded["bl"], device=dev))
    print(f"# dist gp: log marginal {sharded['marginal']:.6f}, from the "
          f"unsharded engine: marginal {errs[0]:.3e}, per-PCSP LL "
          f"{errs[1]:.3e}; after one sweep: branch lengths {bl_err.max():.3e}"
          f" ({int(past.sum())} of {past.size} past {GP_DIST_BOUND:g}), "
          f"marginal {errs[2]:.3e} (bound "
          f"{GP_DIST_BOUND:g} absolute); sweep {sharded['sweep_s']:.3f} s "
          f"sharded ({sharded['all_reduces'][1]} all_reduces, "
          f"{sharded['all_reduces'][0]:.3f} s of it, the card synchronised "
          f"around each), {whole['sweep_s']:.3f} s unsharded on this rank",
          flush=True)
    check(max(errs) <= GP_DIST_BOUND and not past.any(),
          "dist gp: within the bound of the unsharded engine")
    return dict(errs=errs, bl_err=float(bl_err.max()),
                bl_past=int(past.sum()),
                sweep_s=(sharded["sweep_s"], whole["sweep_s"]),
                all_reduces=sharded["all_reduces"])


def dist_vbpi(dev, tmp):
    """The vbpi path's trainer at config4's shape on this rank, its
    instance engine pattern-sharded, beside the same trainer unsharded
    (the same seed, so the same samples): one warm-up step, then
    DIST_VBPI_STEPS timed steps (host clock after a barrier, the card
    synchronised at both ends) and estimate_elbo; the last sample's LL
    and branch gradients (phylo_gradients) held to the unsharded
    trainer's within BOUND (LL relative, gradients max-abs over max |g|),
    the ELBO within BOUND relative and the SBN and scalar parameters
    within BOUND absolute; the same samples as unsharded, and the same
    LLs on every rank."""
    nexus, fasta = _synthetic.write_vbpi_inputs(
        tmp, SEED, _synthetic.DS1_TAXA, VBPI_TREES, _synthetic.DS1_SITES,
        _synthetic.DS1_DISTINCT_COLUMNS)
    runs = []
    for shard in (False, True):
        burrito = Burrito(
            mcmc_nexus_path=nexus, burn_in_fraction=0.0, fasta_path=fasta,
            phylo_model_specification=PhyloModelSpecification(*VBPI_SPEC),
            branch_model_name="split", scalar_model_name="lognormal",
            optimizer_name="simple", particle_count=VBPI_PARTICLES,
            seed=SEED, device=dev, dtype=PRODUCT_DTYPE)
        if shard:
            burrito.inst.engine.shard_patterns()
        burrito.gradient_step()  # warm-up
        torch.distributed.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(DIST_VBPI_STEPS):
            burrito.gradient_step()
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / DIST_VBPI_STEPS
        grads = burrito.inst.phylo_gradients()
        runs.append(dict(
            ms=step_ms, elbo=burrito.estimate_elbo(VBPI_PARTICLES),
            keys=[t.topology.key() for t in burrito.inst.tree_collection.trees],
            ll=torch.as_tensor([g.log_likelihood_ for g in grads]),
            grad=torch.as_tensor(np.stack([g.gradient["branch_lengths"]
                                           for g in grads])),
            sbn=np.array(burrito.inst.sbn_parameters),
            q=np.array(burrito.branch_model.scalar_model.q_params),
            width=burrito.inst.engine.pattern_pad))
        del burrito
    whole, sharded = runs
    check(sharded["keys"] == whole["keys"],
          "dist vbpi: the sharded trainer drew the unsharded one's trees")
    same_on_every_rank("vbpi", sharded["ll"].to(dev))
    errs = dict(ll=rel_err(sharded["ll"], whole["ll"]),
                grad=norm_err(sharded["grad"], whole["grad"]),
                elbo=abs(sharded["elbo"] - whole["elbo"]) / abs(whole["elbo"]),
                sbn=float(np.abs(sharded["sbn"] - whole["sbn"]).max()),
                q=float(np.abs(sharded["q"] - whole["q"]).max()))
    print(f"# dist vbpi: config4's trainer ({_synthetic.DS1_TAXA} taxa, "
          f"{VBPI_PARTICLES} particles, {sharded['width']} of "
          f"{whole['width']} patterns on this rank), after "
          f"{1 + DIST_VBPI_STEPS} steps sharded against unsharded: "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f" (bound {BOUND:g}); ms a step on this rank: sharded "
          f"{sharded['ms']:.2f}, unsharded {whole['ms']:.2f}", flush=True)
    check(max(errs.values()) <= BOUND,
          "dist vbpi: the sharded step within the bound of the unsharded")
    return dict(errs=errs, ms=(sharded["ms"], whole["ms"]))


def dist_worker(label, outdir):
    """A rank of the dist path, started by dist.launch (`import
    bito_tpu_torch` joined the job): `gloo` runs the flagship's auto and
    chunked routes, the codon path's auto and the GP engine sharded;
    `nccl`, one rank, the flagship's auto route, equal to the unsharded
    call.  Writes its results to OUTDIR/<label>.<rank>.json."""
    check(torch.distributed.is_initialized(), "the worker joined the job")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = multihost.local_device()
    torch.cuda.set_device(dev)
    rank = multihost.process_index()
    _kernels.library()
    out = {"rank": rank, "size": multihost.process_count(),
           "backend": torch.distributed.get_backend(), "card": card_line()}
    trees, sp, model = flagship()
    params = params_from_numpy(PARAMS, dev, PRODUCT_DTYPE)
    whole = TreeLikelihoodEngine(sp, model, device=dev, dtype=PRODUCT_DTYPE)
    sharded = TreeLikelihoodEngine(sp, model, device=dev,
                                   dtype=PRODUCT_DTYPE)
    sharded.shard_patterns()
    if label == "nccl":
        ll, (ll2, g) = (sharded.log_likelihoods(trees, params),
                        sharded.ll_and_branch_gradients(trees, params))
        w_ll, (w_ll2, w_g) = (whole.log_likelihoods(trees, params),
                              whole.ll_and_branch_gradients(trees, params))
        check(torch.equal(ll, w_ll) and torch.equal(ll2, w_ll2)
              and torch.equal(g, w_g), "dist nccl: one rank's sharded auto "
              "call equals the unsharded call")
        fn = sharded.branch_eval_fn(trees, params)
        bl = sharded.branch_length_matrix(trees, sharded.encode(trees))
        out["call_ms"] = cuda_ms(lambda: fn(bl), DIST_REPS)
        print(f"# dist nccl: one rank, the auto call equal to the unsharded "
              f"call; {out['call_ms']:.4f} ms a call", flush=True)
    else:
        ref = TreeLikelihoodEngine(sp, model, device=dev, dtype=torch.float64)
        ref.kernel = "scan"
        refs = ref.ll_and_branch_gradients(
            trees, params_from_numpy(PARAMS, dev, torch.float64))
        del ref
        for kernel in ("auto", "chunked"):
            out[kernel] = dist_route(kernel, kernel, sharded, whole, trees,
                                     params, refs, BOUND)
        del whole, sharded, refs
        ctrees, csp, cmodel, cparams_np = codon_workload()
        cparams = params_from_numpy(cparams_np, dev, PRODUCT_DTYPE)
        cref = TreeLikelihoodEngine(csp, cmodel, device=dev,
                                    dtype=torch.float64)
        crefs = cref.ll_and_branch_gradients(
            ctrees, params_from_numpy(cparams_np, dev, torch.float64))
        del cref
        cwhole = TreeLikelihoodEngine(csp, cmodel, device=dev,
                                      dtype=PRODUCT_DTYPE)
        csharded = TreeLikelihoodEngine(csp, cmodel, device=dev,
                                        dtype=PRODUCT_DTYPE)
        csharded.shard_patterns()
        out["codon"] = dist_route("codon", "auto", csharded, cwhole, ctrees,
                                  cparams, crefs, A64_BOUND)
        del cwhole, csharded
        with tempfile.TemporaryDirectory() as tmp:
            out["gp"] = dist_gp(dev, tmp)
        with tempfile.TemporaryDirectory() as tmp:
            out["vbpi"] = dist_vbpi(dev, tmp)
    with open(os.path.join(outdir, f"{label}.{rank}.json"), "w") as f:
        json.dump(out, f)
    torch.distributed.destroy_process_group()


REFUSED = "open(__import__('sys').argv[1], 'w').close()\n"


def launch(args, cwd):
    """Run dist.launch with `args` (no worker output is lost: the
    launcher's own lines and each worker's `[p<i>]` lines)."""
    return subprocess.run(
        [sys.executable, "-m", "bito_tpu_torch.dist.launch", *args],
        cwd=cwd, capture_output=True, text=True, timeout=DIST_HARD_S + 60)


def dist_path(card):
    """Phase 3's dist path: the port's launcher runs DIST_RANKS ranks on the
    one card over Gloo (dist_worker "gloo"), then one rank over NCCL
    ("nccl"), and is refused NCCL for two ranks on one card before any
    worker starts.  A rank that fails or goes silent past DIST_STALL_S
    makes the launcher, and so this script, fail.  Returns the ranks'
    results."""
    here = os.path.dirname(os.path.abspath(__file__))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, n in (("gloo", DIST_RANKS), ("nccl", 1)):
            t0 = time.perf_counter()
            proc = launch(["-n", str(n), "--backend", label, "--device",
                           "cuda", "--stall-timeout", str(DIST_STALL_S),
                           "--hard-timeout", str(DIST_HARD_S),
                           os.path.abspath(__file__), "--dist-worker", label,
                           tmp], here)
            for line in proc.stdout.splitlines():
                if "] # dist" in line:
                    print(f"# phase 3: {line}")
            check(proc.returncode == 0,
                  f"the {label} dist run: launcher exit {proc.returncode}\n"
                  + proc.stdout[-4000:] + proc.stderr[-4000:])
            print(f"# phase 3: dist {label}: {n} rank(s) in "
                  f"{time.perf_counter() - t0:.1f} s")
            runs[label] = []
            for r in range(n):
                with open(os.path.join(tmp, f"{label}.{r}.json")) as f:
                    runs[label].append(json.load(f))
        marker = os.path.join(tmp, "started")
        with open(os.path.join(tmp, "refused.py"), "w") as f:
            f.write(REFUSED)
        proc = launch(["-n", "2", "--backend", "nccl", "--device", "cuda",
                       os.path.join(tmp, "refused.py"), marker], here)
        check(proc.returncode != 0 and "NCCL takes one card a rank"
              in proc.stderr and not os.path.exists(marker),
              "NCCL for two ranks on one card is refused before any worker "
              "starts")
        print("# phase 3: dist: NCCL for two ranks on one card refused "
              f"before any worker started ({proc.stderr.strip()})")
    for kernel in ("auto", "chunked", "codon"):
        res = [r[kernel] for r in runs["gloo"]]
        launches = {k: [r["launches"][k] for r in res]
                    for k in DIST_EXPECT[kernel]}
        times = {k: [r["times"][k] for r in res] for k in res[0]["times"]}
        print(f"# phase 3: dist {kernel} summary, per rank: launches "
              f"{launches}; " + ", ".join(
                  f"{k} " + "/".join(f"{v:.4f}" for v in vs)
                  for k, vs in times.items()) + f" (ms a call; two ranks "
              f"share the card) on {card}")
    vbpi = [r["vbpi"] for r in runs["gloo"]]
    print("# phase 3: dist vbpi summary, per rank: ms a step sharded "
          + "/".join(f"{r['ms'][0]:.2f}" for r in vbpi) + ", unsharded "
          + "/".join(f"{r['ms'][1]:.2f}" for r in vbpi) + " (two ranks "
          f"share the card) on {card}")
    return runs


GRAFT_REPS = 50  # CUDA-event calls of entry()'s forward and its kernel


def graft_path(card):
    """The graft path (phase 3): the driver's entry points on the card.
    entry()'s forward in float32 with the launch counts set to 0 just
    before and read just after (paired_ll_onchip alone), held to the
    float64 plain version on the same inputs within BOUND (LL relative),
    and timed beside the kernel alone; then the ranks' results of
    dryrun_multichip(DIST_RANKS) (graft_entry.dryrun_results), whose ranks
    share the card over Gloo (its launcher's backend rule): its OK line,
    programs 1, 3 and 4 within graft_entry.BOUND of the float64 plain
    versions (each rank raises past it), and each rank's launches of rows
    1-2, which must include both paired on-chip kernels on every rank.
    Returns (the forward's
    launches of paired_ll_onchip, [each rank's {kernel: launches} of
    rows 1-2])."""
    fn, args = graft_entry.entry()
    check(all(a.device.type == "cuda" and a.dtype == torch.float32
              for a in args), "graft: entry() defaults to the card in "
          "float32")
    reset_launches()
    ll = fn(*args)
    torch.cuda.synchronize()
    read_launches("graft")
    forward_launches = KERNELS["paired_ll_onchip"]["wrapper"].launches
    fn64, _ = graft_entry.entry(device="cpu")
    ref = fn64(*[a.detach().cpu().double() for a in args])
    check(ll.shape == ref.shape == (4,) and bool(torch.isfinite(ll).all()),
          "graft: entry()'s forward gives 4 finite LLs")
    err = rel_err(ll.cpu(), ref)
    forward_ms = cuda_ms(lambda: fn(*args), GRAFT_REPS)
    ops = fn.operands(*args)
    onchip = graft_entry._paired_tapes(graft_entry._toy_inputs()[0],
                                       ops[0].device)[-1]
    kernel_ms = cuda_ms(lambda: paired.paired_log_likelihoods(
        *ops, onchip=onchip), GRAFT_REPS)
    print(f"# phase 3: graft path: entry() forward ({ops[0].shape[0]} trees "
          f"x {ops[4].shape[-1]} patterns, {ops[4].shape[0]} taxa, "
          f"GTR+Gamma4, rooted): launches {{'paired_ll_onchip': "
          f"{forward_launches}}}; LL rel err {err:.3e} against the float64 "
          f"plain version (bound {BOUND:g}); {forward_ms:.4f} ms a call "
          f"(CUDA events, P formed on the card), the kernel alone "
          f"{kernel_ms:.4f} ms on {card}")
    check(err <= BOUND, "graft: the forward within the bound of float64")
    t0 = time.perf_counter()
    results = graft_entry.dryrun_results(DIST_RANKS)
    seconds = time.perf_counter() - t0
    ranks = []
    for r in results:
        print(f"# phase 3: graft {graft_entry.rank_line(DIST_RANKS, r)}")
        check(r["backend"] == "gloo" and r["device"].startswith("cuda")
              and r["dtype"] == "float32", f"graft: rank {r['rank']} ran "
              "over Gloo on the card in float32")
        counts = {name: sum(c[name] for c in r["launches"].values())
                  for name in graft_entry.ROW_LAUNCHERS}
        check(counts["paired_ll_onchip"] > 0
              and counts["paired_grad_onchip"] > 0,
              f"graft: rank {r['rank']} launched rows 1-2")
        ranks.append(counts)
    check([r["rank"] for r in results] == list(range(DIST_RANKS)),
          "graft: every rank reported")
    r = results[0]
    for program in ("train", "flagship", "vbpi"):
        check(max(r[f"{program}_err"]) <= graft_entry.BOUND,
              f"graft: the dryrun's {program} within the bound of float64")
    print(f"# phase 3: graft {graft_entry.ok_line(DIST_RANKS, r)}")
    print(f"# phase 3: graft dryrun_multichip({DIST_RANKS}) in "
          f"{seconds:.1f} s; against the float64 plain versions, unsharded "
          f"(LL rel, gradients rel to the largest; bound "
          f"{graft_entry.BOUND:g}): training step {r['train_err']}, "
          f"flagship engine (LL+grad, then LL alone) {r['flagship_err']}, "
          f"VBPI engine on its last sample {r['vbpi_err']}; rows 1-2 "
          "launches per rank "
          + "; ".join(f"rank {i} {c}" for i, c in enumerate(ranks))
          + f" (two ranks share the card) on {card}")
    return forward_launches, ranks


def leveled_path(ref, trees, params64, card):
    """The leveled variant (use_leveled) in float64 at the flagship shape,
    held to the scan tape within LEVELED_BOUND (LL relative, gradients
    max-abs over max |g|); no hand-written kernel launches; its ms beside
    the scan tape's."""
    ref.kernel = "scan"
    ll_s, g_s = ref.ll_and_branch_gradients(trees, params64)
    ref.use_leveled = True
    reset_launches()
    ll_l = ref.log_likelihoods(trees, params64)
    ll_g, g_l = ref.ll_and_branch_gradients(trees, params64)
    torch.cuda.synchronize()
    counts = {name: spec["wrapper"].launches for name, spec in KERNELS.items()}
    check(not any(counts.values()), "leveled: no kernel launched")
    errs = (rel_err(ll_l, ll_s), rel_err(ll_g, ll_s), norm_err(g_l, g_s))
    bl = ref.branch_length_matrix(trees, ref.encode(trees))
    fn = ref.branch_eval_fn(trees, params64)
    lev_ms = cuda_ms(lambda: fn(bl), 3, warmup=1)
    ref.use_leveled = False
    fn = ref.branch_eval_fn(trees, params64)
    scan_ms = cuda_ms(lambda: fn(bl), 3, warmup=1)
    lev = ref.encode_leveled(trees)
    print(f"# phase 3: leveled path (float64, {len(trees)} trees, "
          f"{lev.post_levels.shape[0]} postorder levels against "
          f"{ref.encode(trees).post_ops.shape[1]} scan ops): LL rel err "
          f"{max(errs[:2]):.3e}, grad max-abs/max|g| {errs[2]:.3e} against "
          f"the scan tape (bound {LEVELED_BOUND:g}); LL+gradient call "
          f"{lev_ms:.4f} ms leveled, {scan_ms:.4f} ms scan tape on {card}")
    check(max(errs) <= LEVELED_BOUND, "leveled: agrees with the scan tape")
    return lev_ms, scan_ms


def cli_path(dev, card):
    """The VI command line (vi/cli.py) on the card: `benchmark` for 2 steps
    on a synthetic data directory X (X_out.t from _synthetic.mcmc_nexus,
    X.fasta from random_alignment at DS1's shape), its launches read as a
    path, its CSVs and final ELBO checked; `dag-to-dot` on the gp path's
    inputs.  Then a Burrito checkpoint (utils/checkpoint.py) restored into
    a fresh Burrito, whose state must be bit-equal."""
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "synth")
        os.makedirs(data)
        nexus = os.path.join(data, "synth_out.t")
        fasta = os.path.join(data, "synth.fasta")
        with open(nexus, "w") as f:
            f.write(_synthetic.mcmc_nexus(SEED + 7, _synthetic.DS1_TAXA,
                                          VBPI_TREES))
        with open(fasta, "w") as f:
            f.write(_synthetic.fasta_text(_synthetic.random_alignment(
                SEED + 8, _synthetic.taxon_names(_synthetic.DS1_TAXA),
                _synthetic.DS1_SITES, _synthetic.DS1_DISTINCT_COLUMNS)))
        prefix = os.path.join(tmp, "run")
        text = io.StringIO()
        reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(text):
            vi_cli.main(["benchmark", "--step-count", "2", "--particle-count",
                         str(VBPI_PARTICLES), "--final-elbo-particle-count",
                         "100", "--device", str(dev), "--out-prefix", prefix,
                         data])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_launches("cli")
        elbo = float(re.search(r"'final_elbo': ([-0-9.e+]+)",
                               text.getvalue()).group(1))
        with open(prefix + "_fitting_results.csv") as f:
            rows = list(csv.reader(f))
        with open(prefix + "_opt_trace.csv") as f:
            trace = list(csv.reader(f))
        check(np.isfinite(elbo), "cli: a finite final ELBO")
        check(rows[0] == ["type", "variable", "value"] and len(rows) > 1
              and all(np.isfinite(float(r[2])) for r in rows[1:])
              and trace[0] == ["index", "elbo"], "cli: the two CSVs")
        nwk, _ = gp_files(tmp)
        dot = os.path.join(tmp, "dag.dot")
        with contextlib.redirect_stdout(text):
            vi_cli.main(["dag-to-dot", "-fasta", fasta, "-newick", nwk,
                         "-output", dot])
        with open(dot) as f:
            check(f.read().startswith("digraph"), "cli: dag-to-dot's .dot")
        print(f"# phase 3: cli path: benchmark, 2 steps of {VBPI_PARTICLES} "
              f"particles ({_synthetic.DS1_TAXA} taxa), {seconds:.2f} s, "
              f"final ELBO {elbo:.4f}, {len(rows) - 1} fitting rows; "
              f"dag-to-dot wrote {os.path.getsize(dot)} bytes; launches "
              f"{launches} on {card}")

        def burrito():
            return Burrito(
                mcmc_nexus_path=nexus, burn_in_fraction=0.1, fasta_path=fasta,
                phylo_model_specification=PhyloModelSpecification(*VBPI_SPEC),
                branch_model_name="split", scalar_model_name="lognormal",
                optimizer_name="simple", particle_count=VBPI_PARTICLES,
                seed=SEED, device=dev, dtype=PRODUCT_DTYPE)

        trained = burrito()
        trained.gradient_step()
        path = os.path.join(tmp, "burrito.npz")
        checkpoint.checkpoint_burrito(trained, path, step=1)
        fresh = burrito()
        check(checkpoint.restore_burrito(fresh, path) == 1,
              "checkpoint: the step")
        opt, opt2 = trained.opt, fresh.opt
        pairs = [(trained.branch_model.scalar_model.q_params,
                  fresh.branch_model.scalar_model.q_params),
                 (trained.inst.sbn_parameters, fresh.inst.sbn_parameters),
                 (np.asarray(opt.step_size), np.asarray(opt2.step_size)),
                 (np.asarray(opt.sbn_step_size),
                  np.asarray(opt2.sbn_step_size)),
                 (np.asarray(opt.adam_count), np.asarray(opt2.adam_count))]
        pairs += [(opt.adam_mu[k], opt2.adam_mu[k]) for k in opt.adam_mu]
        pairs += [(opt.adam_nu[k], opt2.adam_nu[k]) for k in opt.adam_nu]
        check(all(np.array_equal(a, b) for a, b in pairs),
              "checkpoint: the restored Burrito's parameters are bit-equal")
        print(f"# phase 3: checkpoint: a Burrito after one step restored "
              f"into a fresh one from {os.path.getsize(path)} bytes, "
              f"{len(pairs)} arrays bit-equal")
    return launches


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py needs an NVIDIA card: "
                 "torch.cuda.is_available() is False")
    # The device line counts the visible cards; the run uses one.
    check(torch.cuda.device_count() == 1,
          f"one visible card, got {torch.cuda.device_count()} "
          "(choose one with CUDA_VISIBLE_DEVICES)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(PRODUCT_DEVICE)
    t_start = time.perf_counter()

    # -- 1. card and build ---------------------------------------------------
    card = card_line()
    print(card)
    print(f"# torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    so = _kernels.build()
    _kernels.library()
    print(f"# phase 1: kernels built in {time.perf_counter() - t0:.1f} s "
          f"({so.name})")
    for kernel, spill, regs in ptxas_usage(so.with_suffix(".log").read_text()):
        print(f"#   ptxas {kernel}: {regs}; {spill}")
    mix = sass_mix(so)
    for kernel in TENSOR_KERNELS:
        ops = mix.get(kernel, collections.Counter())
        print(f"#   SASS {kernel}: {sum(ops.values())} instructions, "
              f"{ops['HMMA']} HMMA, {ops['HGMMA']} HGMMA; most used "
              + ", ".join(f"{op} {n}" for op, n in ops.most_common(10)))
        check(ops["HMMA"] + ops["HGMMA"] > 0,
              f"{kernel} runs on the tensor cores (HMMA or HGMMA in its SASS)")

    # -- the workload ---------------------------------------------------------
    trees, sp, model = flagship()
    eng = TreeLikelihoodEngine(sp, model, device=dev, dtype=PRODUCT_DTYPE)
    ref = TreeLikelihoodEngine(sp, model, device=dev, dtype=torch.float64)
    params = params_from_numpy(PARAMS, dev, PRODUCT_DTYPE)
    params64 = params_from_numpy(PARAMS, dev, torch.float64)
    enc = eng.encode(trees)
    ce = chunked.build_chunked_encoding(enc, chunked.W)
    print(f"# workload: {sp.num_taxa} taxa, {sp.site_count} sites, "
          f"{sp.pattern_count} patterns (pad {eng.pattern_pad}), "
          f"{len(trees)} trees, {enc.num_slots} nodes, GTR+Gamma4; "
          f"chunked tape W={ce.W}, {ce.Mc} chunks")

    # -- 2. kernels against their plain versions ------------------------------
    ends = [time.perf_counter()]  # each phase's end, for its duration
    bl = eng.branch_length_matrix(trees, enc)
    eig, rates, props, clock = eng._model_ingredients(params, BATCH)
    pi, prop = prep.kernel_model(eig, props)
    tips, w = eng._kernel_tips, eng._kernel_weights
    dst, tip, src, e, mask = eng._paired_tapes(enc)
    onchip = eng._onchip_tape(enc)
    P, dPq = prep.prepare_inputs_grad_q(eig, rates, clock, bl)
    _, dP = prep.prepare_inputs_grad(eig, rates, clock, bl)
    cdst, ctip, cedge, crow, _ = eng._chunked_tapes(enc)
    con = eng._chunked_onchip_tape(enc)
    post, pre, root = (torch.as_tensor(x, dtype=torch.int32, device=dev)
                       for x in (enc.post_ops, enc.pre_ops, enc.root))
    pon = pernode.onchip_tape(enc.post_ops, enc.pre_ops, enc.root,
                              enc.num_taxa, enc.num_slots, dev)
    pll = pernode.ll_tape(enc.post_ops, enc.root, enc.num_taxa,
                          enc.num_slots, dev)
    ll_ops = (dst, tip, e, P, tips, pi, prop, w)
    grad_ops = (dst, tip, src, e, mask, P, dPq, tips, pi, prop, w)
    check(all(paired.onchip_plan(k, r, M, P.shape[1], 4)
              for k, r, M in (("ll", onchip.ll_rows, dst.shape[1]),
                              ("grad", onchip.grad_rows, dst.shape[1]),
                              ("ll", pll.ll_rows, post.shape[1])))
          and chunked.ll_plan(con.ll_rows, cdst.shape[1], P.shape[1], 4)
          and chunked.onchip_plan(con.grad_rows, cdst.shape[1], P.shape[1], 4)
          and pernode.onchip_plan(pon.rows, pon.ints, P.shape[1], 4),
          "the flagship fits the on-chip bodies")
    args = {  # kernel -> (plain version, its arguments, call of the kernel)
        "paired_ll_onchip": (  # the wrappers' body here
            paired.paired_log_likelihoods_ref, ll_ops,
            lambda: paired.paired_log_likelihoods(*ll_ops, onchip=onchip)),
        "paired_grad_onchip": (
            paired.paired_ll_and_gradients_ref, grad_ops,
            lambda: paired.paired_ll_and_gradients(*grad_ops, onchip=onchip)),
        "paired_ll": (  # the global body, through the same final sums
            paired.paired_log_likelihoods_ref, ll_ops,
            lambda: paired.paired_ll_global(dst, tip, e, P, tips, pi,
                                            prop) @ w),
        "paired_grad": (
            paired.paired_ll_and_gradients_ref, grad_ops,
            lambda: paired.finish_rows(*paired.paired_grad_global(
                dst, tip, src, e, P, dPq, tips, pi, prop, w), mask, w)),
    }
    cgrad_ops = (cdst, ctip, cedge, crow, mask, P, dP, tips, pi, prop, w)
    args["chunked_grad_onchip"] = (  # the wrapper's body here
        chunked.chunked_ll_and_gradients_ref, cgrad_ops,
        lambda: chunked.chunked_ll_and_gradients(*cgrad_ops, onchip=con))
    args["chunked_grad"] = (  # the global body, through the same final sums
        chunked.chunked_ll_and_gradients_ref, cgrad_ops,
        lambda: chunked.finish_rows(*chunked.chunked_grad_global(
            cdst, ctip, cedge, P, dP, tips, pi, prop, w), crow, mask, w))
    cll_ops = (cdst, ctip, cedge, P, tips, pi, prop, w)
    args["chunked_ll_onchip"] = (  # the wrapper's body here
        chunked.chunked_log_likelihoods_ref, cll_ops,
        lambda: chunked.chunked_log_likelihoods(*cll_ops, onchip=con))
    args["chunked_ll"] = (  # the global body, through the same final sum
        chunked.chunked_log_likelihoods_ref, cll_ops,
        lambda: chunked.chunked_ll_global(cdst, ctip, cedge, P, tips, pi,
                                          prop) @ w)
    pll_ops = (post, root, P, tips, pi, prop, w)
    args["pernode_ll_onchip"] = (  # the wrapper's body here
        pernode.pernode_log_likelihoods_ref, pll_ops,
        lambda: pernode.pernode_log_likelihoods(*pll_ops, onchip=pll))
    args["pernode_ll"] = (  # the global body, through the same final sum
        pernode.pernode_log_likelihoods_ref, pll_ops,
        lambda: pernode.pernode_ll_global(post, root, P, tips, pi, prop) @ w)
    # The checkpointed grad body, forced on the flagship's trees: its
    # schedule at CKPT_FLAGSHIP_OPS ops a clade (the flagship's tapes keep
    # the on-chip plan, so the engine builds none)
    ckpt_flag = paired.ckpt_tape(*(x.cpu().numpy() for x in (
        dst, onchip.child, e, src)), dev, ops=CKPT_FLAGSHIP_OPS)
    pgrad_ops = (post, pre, root, mask, P, dP, tips, pi, prop, w)
    args["pernode_grad_onchip"] = (  # the wrapper's body here
        pernode.pernode_ll_and_gradients_ref, pgrad_ops,
        lambda: pernode.pernode_ll_and_gradients(*pgrad_ops, onchip=pon))
    args["pernode_grad"] = (  # the global body, through the same final sums
        pernode.pernode_ll_and_gradients_ref, pgrad_ops,
        lambda: pernode.finish_rows(*pernode.pernode_grad_global(
            post, pre, root, P, dP, tips, pi, prop, w), mask, w))
    errs = {}  # kernel -> (relative or max-norm error, max abs error)
    for ll_name, grad_name in (("paired_ll_onchip", "paired_grad_onchip"),
                               ("paired_ll", "paired_grad"),
                               ("chunked_ll_onchip", "chunked_grad_onchip"),
                               ("chunked_ll", "chunked_grad"),
                               ("pernode_ll_onchip", "pernode_grad_onchip"),
                               ("pernode_ll", "pernode_grad")):
        ll_k = args[ll_name][2]()
        ll_g, g_k = args[grad_name][2]()
        torch.cuda.synchronize()
        plain, grad_args, _ = args[grad_name]
        ll_p, g_p = plain(*[x.double() if x.is_floating_point() else x
                            for x in grad_args])
        errs[ll_name] = (rel_err(ll_k, ll_p),
                         (ll_k.double() - ll_p).abs().max().item())
        errs[grad_name] = (norm_err(g_k, g_p),
                           (g_k.double() - g_p).abs().max().item())
        ll_g_err = rel_err(ll_g, ll_p)
        print(f"# phase 2: {ll_name} LL rel err {errs[ll_name][0]:.3e}; "
              f"{grad_name} LL rel err {ll_g_err:.3e}, grad max-abs/max|g| "
              f"{errs[grad_name][0]:.3e} (bound {BOUND:g}, plain version "
              f"in float64 on the same operands)")
        check(errs[ll_name][0] <= BOUND, f"{ll_name} LL parity")
        check(ll_g_err <= BOUND, f"{grad_name} LL parity")
        check(errs[grad_name][0] <= BOUND, f"{grad_name} gradient parity")
    ckpt_parity(lambda: paired.finish_rows(*paired.paired_grad_ckpt(
        ckpt_flag, P, dPq, tips, pi, prop, w), mask, w), grad_ops, ckpt_flag)
    del ckpt_flag

    lab_ops = dict(post_ops=post, pre_ops=pre, root=root, edge_mask=mask, P=P,
                   dP=dP, tips=tips, pi=pi, props=prop, weights=w)
    lab_calls, plain_outs, probe_work = probe_parity(lab_ops, dev, errs)
    chunk_lab_parity(enc, (P, tips, pi, prop, w), (cdst, ctip, cedge, con),
                     dev, errs)
    rooted_dir = tempfile.TemporaryDirectory()
    rooted_inputs = rooted_files(rooted_dir.name)
    rooted_calls = rooted_parity(rooted_inputs, dev)
    codon_work, codon_calls = codon_parity(dev, errs)
    codon_edge_parity(dev)
    pernode_a64_launches = codon_pernode_parity(dev)
    category_parity(dev, errs)
    pernode_a64_launches = [a + b for a, b in zip(
        pernode_a64_launches, codon_category_parity(dev, errs))]
    t0 = time.perf_counter()
    wide_parity(dev, errs)
    print(f"# phase 2: past 32 categories took {time.perf_counter() - t0:.1f}"
          " s")
    prep_work, prep_calls = prep_parity(sp, bl, dev, errs)

    ends.append(time.perf_counter())
    # -- 3. the paths ------------------------------------------------------------
    scales = [1.0 + 0.001 * k for k in range(SWEEP)]
    ll_ref, g_ref = ref.ll_and_branch_gradients(trees, params64)
    ref_fn = ref.branch_eval_fn(trees, params64)
    bl64 = bl.double()
    refs = [(ll_ref, g_ref)] + [ref_fn(bl64 * f) for f in scales]

    def against_reference(path, lls, pairs, refs=refs, bound=BOUND):
        """Hold the path's (ll) and sweep (ll, grads) against the float64
        engine's `refs` within `bound`: lls at the base branch lengths,
        pairs [(ll, grads)] beside refs, at the base and then at scaled
        lengths."""
        ll_r0, g_r0 = refs[0]
        check(pairs[0][0].shape == ll_r0.shape
              and pairs[0][1].shape == g_r0.shape, f"{path} output shapes")
        outs = list(lls) + [x for pair in pairs for x in pair]
        check(all(bool(torch.isfinite(x).all()) for x in outs),
              f"{path} outputs are finite")
        ll_errs = [rel_err(x, ll_r0) for x in lls]
        g_errs = []
        for (ll_k, g_k), (ll_r, g_r) in zip(pairs, refs):
            ll_errs.append(rel_err(ll_k, ll_r))
            g_errs.append(norm_err(g_k, g_r))
        print(f"# phase 3: {path} path against the float64 engine (scan "
              f"tape), worst over {len(g_errs)} calls: LL rel err "
              f"{max(ll_errs):.3e}, grad max-abs/max|g| {max(g_errs):.3e} "
              f"(bound {bound:g})")
        check(max(ll_errs + g_errs) <= bound,
              f"{path} path agrees with the float64 engine")

    launches = {}
    reset_launches()
    ll = eng.log_likelihoods(trees, params)
    pairs = [eng.ll_and_branch_gradients(trees, params)]
    fn = eng.branch_eval_fn(trees, params)
    pairs += [fn(bl * f) for f in scales]
    torch.cuda.synchronize()
    launches.update(read_launches("paired"))
    against_reference("paired", [ll], pairs)

    # The categories path: auto at CATEGORY_PATH_C rate categories.
    cat_eng, cat_launches = categories_path(trees, sp, params, params64, dev,
                                            against_reference)
    launches.update(cat_launches)

    # The large path: the same entry points, past the on-chip bodies.
    ltrees, lsp, lmodel = large_trees()
    large = TreeLikelihoodEngine(lsp, lmodel, device=dev, dtype=PRODUCT_DTYPE)
    large64 = TreeLikelihoodEngine(lsp, lmodel, device=dev,
                                   dtype=torch.float64)
    lenc = large.encode(ltrees)
    lon = large._onchip_tape(lenc)
    lM, lN1 = large._paired_tapes(lenc)[0].shape[1], lenc.num_slots + 1
    print(f"# phase 3: large path: {lsp.num_taxa} taxa, {len(ltrees)} trees, "
          f"{large.pattern_pad} patterns; {lon.ll_rows} live rows (LL) and "
          f"{lon.grad_rows} rows (grad) a pattern; on-chip plans "
          f"{paired.onchip_plan('ll', lon.ll_rows, lM, lN1, 4)} (LL), "
          f"{paired.onchip_plan('grad', lon.grad_rows, lM, lN1, 4)} (grad); "
          f"the checkpointed grad body's schedule {lon.ckpt.rows} rows a "
          f"pattern, {lon.ckpt.slots} tier slots a tree, "
          f"{lon.ckpt.sched.shape[1]} entries")
    lbl = large.branch_length_matrix(ltrees, lenc)
    lscales = scales[:3]
    lfn64 = large64.branch_eval_fn(ltrees, params64)
    lrefs = [large64.ll_and_branch_gradients(ltrees, params64)] + [
        lfn64(lbl.double() * f) for f in lscales]
    reset_launches()
    ll = large.log_likelihoods(ltrees, params)
    pairs = [large.ll_and_branch_gradients(ltrees, params)]
    fn = large.branch_eval_fn(ltrees, params)
    pairs += [fn(lbl * f) for f in lscales]
    torch.cuda.synchronize()
    launches.update(read_launches("large"))
    against_reference("large", [ll], pairs, lrefs)

    # The chunked route on the same trees, past the on-chip grad body.
    large.kernel = "chunked"
    lce = large._chunked_tapes(lenc)[0]
    lcon = large._chunked_onchip_tape(lenc)
    print(f"# phase 3: large-chunked path: MW={lce.shape[1]}, "
          f"{lcon.ll_rows} live rows (LL) and {lcon.grad_rows} rows (grad) "
          f"a pattern; on-chip plans "
          f"{chunked.ll_plan(lcon.ll_rows, lce.shape[1], lN1, 4)} "
          f"(LL), {chunked.onchip_plan(lcon.grad_rows, lce.shape[1], lN1, 4)}"
          " (grad)")
    reset_launches()
    ll = large.log_likelihoods(ltrees, params)
    pairs = [large.ll_and_branch_gradients(ltrees, params)]
    fn = large.branch_eval_fn(ltrees, params)
    pairs += [fn(lbl * f) for f in lscales]
    torch.cuda.synchronize()
    launches.update(read_launches("large-chunked"))
    against_reference("large-chunked", [ll], pairs, lrefs)

    # The per-node functions on the same trees, past the on-chip grad body.
    leig, lrates, lprops, lclock = large._model_ingredients(params,
                                                            len(ltrees))
    lpi, lprop = prep.kernel_model(leig, lprops)
    lpost, lpre, lroot = (torch.as_tensor(x, dtype=torch.int32, device=dev)
                          for x in (lenc.post_ops, lenc.pre_ops, lenc.root))
    lmask = torch.as_tensor(lenc.edge_mask, dtype=torch.float32, device=dev)
    lpon = pernode.onchip_tape(lenc.post_ops, lenc.pre_ops, lenc.root,
                               lenc.num_taxa, lenc.num_slots, dev)
    lpll = pernode.ll_tape(lenc.post_ops, lenc.root, lenc.num_taxa,
                           lenc.num_slots, dev)
    print(f"# phase 3: large-pernode path: {lpll.ll_rows} live rows (LL) "
          f"and {lpon.rows} rows (grad) a pattern; on-chip plans "
          f"{paired.onchip_plan('ll', lpll.ll_rows, lpost.shape[1], lN1, 4)} "
          f"(LL), {pernode.onchip_plan(lpon.rows, lpon.ints, lN1, 4, least=1)}"
          " (grad)")
    ltips, lw = large._kernel_tips, large._kernel_weights
    reset_launches()
    lP, _ = prep.prepare_inputs_grad(leig, lrates, lclock, lbl)
    ll = pernode.pernode_log_likelihoods(lpost, lroot, lP, ltips, lpi, lprop,
                                         lw, onchip=lpll)
    pairs = []
    for f in [1.0] + lscales:
        Pk, dPk = prep.prepare_inputs_grad(leig, lrates, lclock, lbl * f)
        pairs.append(pernode.pernode_ll_and_gradients(
            lpost, lpre, lroot, lmask, Pk, dPk, ltips, lpi, lprop, lw,
            onchip=lpon))
    torch.cuda.synchronize()
    launches.update(read_launches("large-pernode"))
    against_reference("large-pernode", [ll], pairs, lrefs)
    del large, large64, lrefs, pairs

    eng.kernel = "chunked"
    reset_launches()
    ll = eng.log_likelihoods(trees, params)
    ll_fn = eng.ll_eval_fn(trees, params)(bl)
    pairs = [eng.ll_and_branch_gradients(trees, params)]
    fn = eng.branch_eval_fn(trees, params)
    pairs += [fn(bl * f) for f in scales]
    torch.cuda.synchronize()
    launches.update(read_launches("chunked"))
    against_reference("chunked", [ll, ll_fn], pairs)
    eng.kernel = "auto"

    reset_launches()
    ll = pernode.pernode_log_likelihoods(post, root, P, tips, pi, prop, w,
                                         onchip=pll)
    pairs = []
    for f in [1.0] + scales:
        Pk, dPk = prep.prepare_inputs_grad(eig, rates, clock, bl * f)
        pairs.append(pernode.pernode_ll_and_gradients(
            post, pre, root, mask, Pk, dPk, tips, pi, prop, w, onchip=pon))
    torch.cuda.synchronize()
    launches.update(read_launches("pernode"))
    against_reference("pernode", [ll], pairs)

    reset_launches()
    lab = run_perflab(lab_ops, dev)
    torch.cuda.synchronize()
    launches.update(read_launches("perflab"))
    check_perflab(lab, plain_outs)

    reset_launches()
    chunk_flag, chunk_out = run_chunklab(dev)
    torch.cuda.synchronize()
    launches.update(read_launches("chunklab"))
    check_chunklab(chunk_flag, chunk_out)

    vbpi_path(dev, card)
    rooted_path(rooted_inputs, dev, card, rooted_calls)
    rooted_dir.cleanup()
    with tempfile.TemporaryDirectory() as gp_dir:
        gp_run = gp_path(gp_files(gp_dir), dev, card)
    with tempfile.TemporaryDirectory() as nni_dir:
        nni_run = nni_path(nni_dir, dev, card)
    codon_run = codon_path(dev, card, against_reference)
    launches.update(codon_run[4])
    # The codon-categories path: auto at MG94+Gamma CODON_CATEGORY_C.
    cc_run = codon_categories_path(dev, against_reference)
    launches.update(cc_run[3])
    # The wide path: GTR+Gamma WIDE_C and MG94+Gamma WIDE_CODON_C on auto.
    t0 = time.perf_counter()
    wide_run = wide_path(dev, against_reference)
    launches.update(wide_run[-1])
    print(f"# phase 3: the wide path took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    dist_path(card)
    print(f"# phase 3: the dist path took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    graft_path(card)
    print(f"# phase 3: the graft path took {time.perf_counter() - t0:.1f} s")
    leveled_path(ref, trees, params64, card)
    cli_path(dev, card)

    # The float64 reference's own gradients against central differences.
    central_differences("", ref, trees, params64, bl64, g_ref)

    ends.append(time.perf_counter())
    # -- 4. times --------------------------------------------------------------
    fl_ll, fl_grad = tree_flops(enc, sp, model, BATCH)
    tape_bytes = {"paired_ll_onchip": nbytes(dst, onchip.child,
                                             onchip.live_row, e),
                  "paired_grad_onchip": nbytes(dst, onchip.child, src, e),
                  "paired_ll": nbytes(dst, tip, e),
                  "paired_grad": nbytes(dst, tip, src, e),
                  "chunked_ll_onchip": nbytes(cdst, con.child, con.live_row,
                                              cedge),
                  "chunked_ll": nbytes(cdst, ctip, cedge),
                  "chunked_grad": nbytes(cdst, ctip, cedge, crow),
                  "chunked_grad_onchip": nbytes(cdst, con.child, cedge,
                                                crow),
                  "pernode_ll_onchip": nbytes(pll.post_dst, pll.child,
                                              pll.live_row, pll.post_e),
                  "pernode_ll": nbytes(post, root),
                  "pernode_grad_onchip": nbytes(pon.post, pon.groups,
                                                pon.zero, root),
                  "pernode_grad": nbytes(post, pre, root),
                  "variant_grad": nbytes(post, pre, root)}
    ll_out, grad_out = BATCH * 4, BATCH * (1 + enc.num_slots) * 4
    work = dict(probe_work)  # kernel -> (FLOPs, bytes, library call)
    for name, moved in tape_bytes.items():
        grad = name.endswith(("_grad", "_grad_onchip", "_grad_ckpt"))
        floats = (nbytes(P, tips, pi, prop, w) + (nbytes(dP, mask) if grad
                                                  else 0))
        work[name] = ((fl_grad if grad else fl_ll),
                      moved + floats + (grad_out if grad else ll_out), None)
    # chunk_variant at v0 (the shipping body): its rows [B, S] out, timed
    # alone into an output allocated once
    chunk_rows = torch.empty((BATCH, tips.shape[-1]), device=dev,
                             dtype=torch.float32)
    work["chunk_variant"] = (fl_ll, nbytes(cdst, con.child, con.live_row,
                                           cedge, P, tips, pi, prop,
                                           chunk_rows), None)
    chunk_plan = chunked.ll_plan(con.ll_rows, cdst.shape[1], P.shape[1], 4)
    times = {}  # kernel -> (ms, plain ms, library ms or None)
    calls = {name: (lambda p=plain, a=a: p(*a), kernel)
             for name, (plain, a, kernel) in args.items()}
    calls.update(lab_calls)
    calls.update(codon_calls)
    work.update(codon_work)
    work.update(prep_work)
    calls.update(prep_calls)
    # Rows 1b-2b at CODON_CATEGORY_C categories, through their wrappers, on
    # the codon-categories path's operands
    cc_work, cc_calls = codon_timed(
        cc_run[0], cc_run[1], *codon_operands(*cc_run[:3]), suffix="@C16")
    work.update(cc_work)
    calls.update(cc_calls)
    # Rows 1-2 at CATEGORY_PATH_C categories, through their wrappers (the
    # on-chip bodies), on the categories path's operands
    cll, cgrad, con16 = paired_operands(cat_eng, trees, params)
    enc16 = cat_eng.encode(trees)
    c_ll, c_grad = tree_flops(enc16, sp, cat_eng.model, BATCH)
    work["paired_ll_onchip@C16"] = (c_ll, nbytes(
        cll[0], con16.child, con16.live_row, *cll[2:]) + ll_out, None)
    work["paired_grad_onchip@C16"] = (c_grad, nbytes(
        cgrad[0], con16.child, *cgrad[2:]) + grad_out, None)
    calls["paired_ll_onchip@C16"] = (
        lambda: paired.paired_log_likelihoods_ref(*cll),
        lambda: paired.paired_log_likelihoods(*cll, onchip=con16))
    calls["paired_grad_onchip@C16"] = (
        lambda: paired.paired_ll_and_gradients_ref(*cgrad),
        lambda: paired.paired_ll_and_gradients(*cgrad, onchip=con16))
    # Rows 3-6 at CATEGORY_PATH_C categories, through their wrappers (the
    # on-chip bodies), on the same engine's chunked and per-node operands
    r_c, r_con, r_p, r_pll, r_pon = rows_operands(cat_eng, trees, params)
    (rdst, rtip, redge, rrow, rmask, rP, rdP, rtips, rpi, rprop,
     rw) = r_c
    rpost, rroot = r_p[0], r_p[2]
    r_ll = nbytes(rP, rtips, rpi, rprop, rw) + ll_out
    r_grad = nbytes(rP, rdP, rtips, rpi, rprop, rw, rmask) + grad_out
    work["chunked_ll_onchip@C16"] = (c_ll, nbytes(
        rdst, r_con.child, r_con.live_row, redge) + r_ll, None)
    work["chunked_grad_onchip@C16"] = (c_grad, nbytes(
        rdst, r_con.child, redge, rrow) + r_grad, None)
    work["pernode_ll_onchip@C16"] = (c_ll, nbytes(
        r_pll.post_dst, r_pll.child, r_pll.live_row, r_pll.post_e) + r_ll,
        None)
    work["pernode_grad_onchip@C16"] = (c_grad, nbytes(
        r_pon.post, r_pon.groups, r_pon.zero, rroot) + r_grad, None)
    calls["chunked_ll_onchip@C16"] = (
        lambda: chunked.chunked_log_likelihoods_ref(
            rdst, rtip, redge, rP, rtips, rpi, rprop, rw),
        lambda: chunked.chunked_log_likelihoods(
            rdst, rtip, redge, rP, rtips, rpi, rprop, rw, onchip=r_con))
    calls["chunked_grad_onchip@C16"] = (
        lambda: chunked.chunked_ll_and_gradients_ref(*r_c),
        lambda: chunked.chunked_ll_and_gradients(*r_c, onchip=r_con))
    calls["pernode_ll_onchip@C16"] = (
        lambda: pernode.pernode_log_likelihoods_ref(
            rpost, rroot, rP, rtips, rpi, rprop, rw),
        lambda: pernode.pernode_log_likelihoods(
            rpost, rroot, rP, rtips, rpi, rprop, rw, onchip=r_pll))
    calls["pernode_grad_onchip@C16"] = (
        lambda: pernode.pernode_ll_and_gradients_ref(*r_p),
        lambda: pernode.pernode_ll_and_gradients(*r_p, onchip=r_pon))
    # Rows 1-6 at WIDE_C and rows 1b-2b at WIDE_CODON_C, through their
    # wrappers, on the wide path's operands
    for timed in (wide_rows_timed(*wide_run[:3]),
                  wide_codon_timed(*wide_run[3:6])):
        work.update(timed[0])
        calls.update(timed[1])
    calls["chunk_variant"] = (
        lambda: perf_chunk_lab.chunk_variant_ref(
            cdst, ctip, cedge, P, tips, pi, prop, variant="v0"),
        lambda: perf_chunk_lab.launch_chunk_variant(
            cdst, con, cedge, P, tips, pi, prop, chunk_plan, chunk_rows,
            variant="v0", rows=con.ll_rows))
    # The checkpointed grad body at the shape the route gives it
    ckpt_trees, ckpt_sp, ckpt_model = body_shape(CKPT_TAXA)
    ckpt_eng = TreeLikelihoodEngine(ckpt_sp, ckpt_model, device=dev,
                                    dtype=PRODUCT_DTYPE)
    (errs["paired_grad_ckpt"], calls["paired_grad_ckpt"],
     work["paired_grad_ckpt"]) = ckpt_entry(ckpt_eng, ckpt_trees, ckpt_sp,
                                            params)
    for name in KERNELS:
        plain, kernel = calls[name]
        library = work[name][2]
        # The probes' launches are short and their wrappers' host work is
        # not: they, and their library call, are timed from the device
        # (graph_ms).
        graphed = name in GRAPH_TIMED
        timer = (partial(graph_ms, counter=KERNELS[name]["wrapper"])
                 if graphed else cuda_ms)
        lib_timer = graph_ms if graphed else cuda_ms
        # plain, kernel, library, kernel, library, plain: all see the same
        # drift.
        p_reps, k_reps, p_warm = KERNELS[name].get("reps", (5, 50, 3))
        p1 = cuda_ms(plain, p_reps, warmup=p_warm)
        k1 = timer(kernel, k_reps)
        l1 = lib_timer(library, k_reps) if library else None
        k2 = timer(kernel, k_reps)
        l2 = lib_timer(library, k_reps) if library else None
        p2 = cuda_ms(plain, p_reps, warmup=p_warm)
        times[name] = ((k1 + k2) / 2, (p1 + p2) / 2,
                       (l1 + l2) / 2 if library else None)
        b_ms, b_by = bound_of(name, work)
        shape = LAB_SHAPES.get(name, f"float32, {BATCH} trees x "
                                     f"{eng.pattern_pad} patterns")
        terms = (f" (terms: device memory {bound(*work[name][:2])[0]:.4f}, "
                 f"shared memory {work[name][3]:.4f})"
                 if len(work[name]) > 3 else "")
        if "peak" in KERNELS[name]:  # on the tensor cores: both bounds
            fma_ms = bound(*work[name][:2])[0]
            terms = (f" at 3xTF32 ({100 * b_ms / times[name][0]:.1f}% of "
                     f"it); at float32 FMAs {fma_ms:.4f} ms ("
                     f"{100 * fma_ms / times[name][0]:.1f}%)")
        print(f"# phase 4: {name} kernel {times[name][0]:.4f} ms ("
              + (GRAPH_TIMING if name in GRAPH_TIMED else "CUDA events around "
                 "the calls") + f"), plain {times[name][1]:.4f} ms"
              + (f", torch.sum {times[name][2]:.4f} ms" if library else "")
              + f", bound {b_ms:.4f} ms by {b_by}{terms} ({shape}) on {card}")
        if name in GRAPH_TIMED:  # a device time under its bound is wrong
            check(times[name][0] >= b_ms, f"{name} within its bound")

    category_times(cat_eng, trees, card)
    paired_rows_times(trees, sp, params, dev, card)
    del cat_eng, cll, cgrad, con16, r_c, r_con, r_p, r_pll, r_pon
    E = int(np.asarray(enc.edge_mask).sum(axis=1).mean())
    chunk_lab_times(chunk_flag, chunk_out,
                    (fl_ll, E * 2 * 16 * 4 * sp.pattern_count * BATCH), card)
    del chunk_flag, chunk_out

    # The pipe plan's rule: every experiment at every tile that fits.
    print(f"# phase 4: pipe_cell at every tile that fits ({GRAPH_TIMING}, "
          f"{LAB_REPS} launches; us/cell, {CELLS} cells), on {card}")
    print("# phase 4: pipe tiles " + json.dumps(
        perf_pipe_lab.tile_sweep(reps=LAB_REPS)))

    # The paired bodies side by side, on the flagship and on further
    # shapes up to the on-chip bodies' limit.
    paired_bodies("flagship", eng, trees, params, card)
    chunked_bodies("flagship", eng, trees, params, card)
    pernode_bodies("flagship", eng, trees, params, card)
    for taxa in BODY_TAXA:
        t2, sp2, model2 = body_shape(taxa)
        eng2 = TreeLikelihoodEngine(sp2, model2, device=dev,
                                    dtype=PRODUCT_DTYPE)
        paired_bodies(f"{taxa} taxa", eng2, t2, params, card)
        chunked_bodies(f"{taxa} taxa", eng2, t2, params, card)
        pernode_bodies(f"{taxa} taxa", eng2, t2, params, card)
        del eng2
        torch.cuda.empty_cache()
    for taxa in PERNODE_TAXA:
        t2, sp2, model2 = body_shape(taxa)
        pernode_bodies(f"{taxa} taxa", TreeLikelihoodEngine(
            sp2, model2, device=dev, dtype=PRODUCT_DTYPE), t2, params, card)
    paired_bodies(f"{CKPT_TAXA} taxa", ckpt_eng, ckpt_trees, params, card)
    del ckpt_eng
    torch.cuda.empty_cache()

    def sweep_evals_per_s(kernel, calls):
        eng.kernel = kernel
        f = eng.branch_eval_fn(trees, params)
        ms = cuda_ms(lambda: f(bl), calls)
        return BATCH / (ms / 1e3), ms

    auto_rate = sweep_evals_per_s("auto", 40)
    rates_line = ", ".join(
        f"{label} {eps:.1f} ({ms:.4f} ms/call)" for label, (eps, ms) in [
            ("paired kernels (auto)", auto_rate),
            ("chunked kernels", sweep_evals_per_s("chunked", 40)),
            ("scan tape", sweep_evals_per_s("scan", 5))])
    eng.kernel = "auto"
    print(f"# phase 4: end to end, DS1-shaped GTR+Gamma4 LL+gradient "
          f"evals/s at B={BATCH}: {rates_line}, on {card}")
    # What a new topology set costs the host, against one call.
    text, aln = _synthetic.ds1_shaped(SEED + 4, TOPOLOGY_BATCH)
    coll = parse_newick_text(text)
    sets = [("B=%d" % BATCH, sp, trees, 5),
            ("B=%d" % TOPOLOGY_BATCH, SitePattern(aln, coll.taxon_names),
             coll.trees, 3)]
    print("# phase 4: a new topology set, host ms before the first launch "
          "(median over fresh engines): " + "; ".join(
              "{}: encoding {:.3f}, paired tapes {:.3f} (the on-chip tape "
              "{:.3f} of it)".format(label, *topology_set_ms(s2, model, t2,
                                                              reps))
              for label, s2, t2, reps in sets)
          + f"; one auto LL+gradient call at B={BATCH} takes "
          f"{auto_rate[1]:.4f} ms on {card}")
    nni_kernel_times(nni_run, dev, card)
    codon_times(codon_run, card, pernode_a64_launches)
    del codon_run
    del cc_calls
    calls.clear()
    torch.cuda.empty_cache()
    codon_category_times(cc_run, times, card)
    del cc_run
    t0 = time.perf_counter()
    wide_times(wide_run, times, card)
    del wide_run
    torch.cuda.empty_cache()
    print(f"# phase 4: the wide times took {time.perf_counter() - t0:.1f} s")
    # Last, since its torch.profiler pass leaves the profiler set up.
    t0 = time.perf_counter()
    gp_times(*gp_run, card)
    del gp_run
    print(f"# phase 4: the gp times took {time.perf_counter() - t0:.1f} s")
    ends.append(time.perf_counter())
    print(f"# chip_smoke.py ran in {ends[-1] - t_start:.1f} s (phases 1-4: "
          + ", ".join(f"{b - a:.1f}" for a, b in zip([t_start] + ends, ends))
          + " s)")

    # -- 5. results -------------------------------------------------------------
    kernels = []
    for name, spec in KERNELS.items():
        b_ms, b_by = bound_of(name, work)
        kernels.append(
            {"name": name, "route": "cuda", "source": spec["source"],
             "replaces": spec["replaces"], "launches": launches[name],
             "max_abs_err": errs[name][1], "ms": times[name][0],
             "plain_ms": times[name][1], "bound_ms": b_ms, "bound_by": b_by,
             "library_ms": times[name][2]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dist-worker"]:  # a rank of the dist path
        dist_worker(*sys.argv[2:4])
    else:
        main()
