"""On-card smoke test of the PyTorch/CUDA port (``xgboost_tpu_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py             # every phase below
    python3 chip_smoke.py --serving   # phases 1, 47 and 48 alone
    python3 chip_smoke.py --pipeline  # phases 1 and 49 alone
    python3 chip_smoke.py --c-api     # phases 1, 39 and 50 alone
    python3 chip_smoke.py --kernelprof  # phases 1 and 51 alone
    python3 chip_smoke.py --scan      # phases 1 and 52 alone

Phases (any failure raises and the script exits non-zero):

1. build all five hand-written kernels from ``xgboost_tpu_torch/csrc/``
   with ``nvcc`` for ``sm_90a``, one process per source, in parallel;
2. the level kernels at the main path's shape (1M x 50 dense rows, real
   logistic gradients, the decision tables of a real grown tree), for
   max_bin 64 (uint8 bins, the full hoist) and max_bin 256 (int16 bins, the
   hoist plan's partial hoist): kernel C (``build_onehot``) bitwise equal to
   its plain version; at every level d = 0..5 kernel D's routing launch
   alone (its per-row channel records and feature-major unhoisted bins)
   bitwise equal to their plain versions, and kernel D (``hoisted_level``)
   and kernel A (``fused_level`` without a one-hot) bitwise equal to each
   other and to their plain versions (``pos`` and the int64 ``hist``), and
   two launches identical; kernel A's routing launch alone (its per-row
   records) bitwise equal to its plain version; at max_bin 256 also kernel
   A at 10M x 50 (the 1M bins, q and positions repeated 10 times, through
   each level's table of the 1M tree), where ``hoist_plan`` itself is 0:
   the int64 histogram 10 x the 1M one at every level;
3. kernel B (``predict_margin``) against its plain version on forests of
   T depth-6 trees with 5% NaNs, T = 1 and 10 on 100k rows, T = 500 on
   100k and on 1M rows (the plain version on the first 10k rows):
   allclose 1e-5;
4. the bin-64 main path through the public entry points: ``train``
   binary:logistic with the depthwise hist grower (max_depth 6, max_bin 64,
   eta 0.1) for 10 rounds on 1M x 50 with AUC/logloss eval on 100k held-out
   rows, then ``predict`` and ``inplace_predict``: the full hoist, so kernel
   C launches once, D 10 x 6 times, A never; held-out AUC >= 0.80 and
   rising;
5. the construct route through the entry points: the same model with
   ``XGBTPU_HOIST_BUDGET_MB=0`` for 3 rounds: kernel A 3 x 6 times, C and D
   never, and the trees identical to the hoisted run's first 3;
6. the reference-default path: the same training with ``max_bin`` left at
   its default, 256 (int16 bins, the partial hoist): C once, D 60 times, A
   never, AUC >= 0.80 and rising, ``inplace_predict`` equal to ``predict``;
7. 3 rounds at max_bin 256 on 64k rows on the card (the hoisted route) and
   on the CPU (the plain construct route): identical trees, predictions
   within 1e-5;
8. each kernel timed with CUDA events around its wrapper (``ms``, median
   of >= 20 launches after warm-up) and by ``torch.profiler`` alone
   (``kernel_ms``: the device time of the kernel's own launches, without
   the wrapper's other device operations and host gaps), beside its plain
   version, its bound and a PyTorch library call where one exists.

Kernel B also walks one input of just over 2^31 elements (43M x 50, in
row chunks), equal to the plain walk on rows at both sides of the 2^31st
element; and the categorical walk (plain torch, on the card) is timed at
T = 10 and 500 on 100k rows.

The categorical path, on the same data with eight columns replaced by
integer codes (``_make_cat_data``: columns 0-1 with 3 categories, the
one-hot regime; 10-12 with 32 and 40-42 with 200, the partition regime and
the latter outside the 33-feature hoisted prefix; 5% NaN each; the label
adds a per-category effect), ``feature_types`` "c", max_bin 256:

9. at every level d = 0..5 of a real categorical tree, with its
   ``[Kp, 261]`` tables: kernel A's and kernel D's routing launches alone
   and both kernels bitwise equal to their plain versions and A equal to
   D; both timed with the wide table and with its first 4 columns;
10. ``train`` for 10 rounds through the entry points (hoisted route): C
    once, D 60 times, A and B never (a categorical forest takes the
    categorical walk); one-hot and partition nodes both grown; held-out
    AUC rising and above the same 10 rounds with every column numerical;
    ``predict`` equal to ``inplace_predict``; the saved JSON, loaded back,
    predicts within 1e-5;
11. the construct route (``XGBTPU_HOIST_BUDGET_MB=0``) for 3 rounds: A 18
    times, C and D never, trees (category sets included) identical to the
    hoisted run's first 3;
12. 3 rounds on the first 64k rows on the card and on the CPU: identical
    trees, split types and category sets; predictions within 1e-5.

The training surface and grower breadth, back on the numerical 1M x 50
data (run after phase 7, before the categorical phases):

13. through the entry points at max_bin 256, depth 6, AUC + logloss
    (``phase_train_surface``): early stopping (60
    rounds at most, stopping on the held-out rows with permuted labels)
    with ``best_iteration``/``best_score`` set and ``predict`` over an
    ``iteration_range`` (kernel B) bitwise equal to the sliced Booster's;
    pickle and ``copy`` bitwise; a learning-rate schedule (0.3 to 0.05
    over 10 rounds) stored tree by tree; continuation (10 + 10 rounds from
    a Booster and from ``save_raw`` bytes; kernel B fills the continued
    cache in its first round) against 20 straight rounds: the first 10
    trees identical, the later ones counted and the held-out margins'
    largest difference reported; a numpy logistic objective and metric
    within 1e-3 AUC of the built-in objective; ``update_many`` bitwise
    equal to per-round ``update``; ``cv`` (3 folds, 200k rows, early
    stopping) with the JAX package's keys; median round times with
    callbacks and eval, bare, and with the numpy objective;
14. grower breadth through the entry points at max_bin 256, depth 6, eta
    0.1, 10 rounds each (``phase_grower_breadth``): (a) uniform row and
    column sampling (0.7 of the rows, and of the columns per tree, level
    and node), (b) MVS at 0.5 with a weighted per-tree column sample, (c)
    monotone constraints on the generator's 10 largest weights (their
    signs) with interaction groups [0..9], [10..29], [30..49]: each run C
    once, D 60 times, A never, B at least 10 times, held-out AUC rising
    (>= 0.75 for (a) and (b)); (c)'s margins monotone along each
    constrained feature on a 1,000 x 21 grid and every root-to-leaf path
    inside one group; (a) by the construct route (A 18 times) with the
    hoisted run's trees; (a) and (c) on the card and on the CPU with the
    same trees; MVS keeping 0.5 of the rows within 2% and a row draw plus
    MVS timed at 1M rows; round times with and without sampling in
    alternating pairs on one matrix.

Objectives and metrics, on the same numerical rows (after phase 14):

15. ``multi:softprob`` with 7 classes (``phase_multiclass``; labels
    ``_multiclass_labels``: argmax of a linear score plus Gumbel noise),
    depth 6, eta 0.1, max_bin 256, 10 rounds, ``merror``/``mlogloss``/
    ``auc`` on the held-out rows: C once, D 10 x 7 x 6 = 420 times, A
    never, B at least 10 times, every walk at G = 7; ``mlogloss`` falling,
    ``merror`` below 1 minus the largest class share, probabilities summing
    to 1 within 1e-5, ``multi:softmax`` on the same model their argmax,
    ``inplace_predict`` equal to ``predict``, the median round time; 3
    rounds by the construct route (A 126 times, the same 21 trees) and 2
    rounds on 64k rows on the card and on the CPU (the same trees; 3
    rounds until phase 44 joined);
16. kernel B at G = 7 (``phase_walk_groups``): on the 7-class model's own
    forest (interleaved ``tree_info``) and on a random 70-tree forest with
    the same groups over 100k rows, against its plain version within
    1e-5, timed beside the same trees walked as one group;
17. the regression family and survival (``phase_objectives``):
    ``reg:squaredlogerror``, ``reg:pseudohubererror``, ``reg:logistic``,
    ``binary:logitraw``, ``binary:hinge``, ``count:poisson``,
    ``reg:gamma``, ``reg:tweedie`` (rho 1.5), ``survival:aft`` (normal;
    60% exact, 30% right-, 10% interval-censored) and ``survival:cox``
    (censored rows negative), 10 rounds each on one 1M x 50 matrix with
    labels that suit each (``_family_labels``): C once on the first run,
    D 60, A 0, B at least 10 per run; the default metric (and ``mae``
    where it applies, ``FAMILY_EXTRA``; ``interval-regression-accuracy``
    for AFT) finite and
    better in round 10 than in round 1; ``count:poisson``, ``reg:gamma``,
    ``reg:tweedie`` and ``reg:pseudohubererror`` on 64k rows for 3 rounds
    on the card and on the CPU: the same trees.

Ranking (after phase 17; ``phase_ranking``), on an MSLR-WEB10K-shaped
configuration (``_make_rank_data``: 136 features with 5% NaN and a
per-query offset, relevance 0-4 at MSLR's skew within each query), the XGBoost
LTR demo's parameters (depth 6, eta 0.1, max_bin 256):

18. ``rank:ndcg`` for 10 rounds through ``train`` on 1M rows in queries of
    60-180 documents (the sampled-pair gradient), ``ndcg@10``/``map@10`` on
    100k held-out rows in whole queries: C once, D 60 times (a partial
    hoist), A never, B at least 10 times; both metrics rising;
    ``inplace_predict`` equal to ``predict``; the saved JSON, loaded back,
    within 1e-5; the median round, the gradient's own time;
19. the inspection surface on that model, card against CPU (``get_score``
    x5, ``get_dump`` text/json/dot with stats, a split-value histogram),
    and ``save_config`` -> ``load_config`` onto a fresh Booster on the card
    training the next round as the original does (that round profiled:
    kernel D's device time per level at F = 136);
20. kernels C, D and A against their plain versions, bitwise, at every
    level of a tree on the 1M x 136 bins with ``rank:ndcg``'s round-0
    gradients (``phase_rank_levels``): the hoist plan's prefix of about 33
    features, D's routing launch writing the other ~103 feature-major, A
    at F = 136; each timed beside its plain version, library call and bound;
21. the construct route (``XGBTPU_HOIST_BUDGET_MB=0``) for 3 rounds: A 18
    times, the same trees; a profiled fourth round: kernel A per level;
22. the all-pairs gradient at full width: 200k rows in queries of 8-32,
    ``rank:pairwise``/``ndcg``/``map`` for 5 rounds each with the default
    metric, the grouped ``auc``, ``pre@5`` and ``ndcg-`` (the default
    metric rising on the training queries);
23. 2 rounds (3 until phase 44 joined) on the card and on the CPU, the
    same trees: ``rank:ndcg`` on a
    partial hoist of about 33 features and ``rank:map`` on the construct
    route, both on 64k rows in queries of 400-1000 (sampled pairs); all
    three on 64k rows of phase 22's data with per-group weights set after
    the first binning.

The other growers and boosters, back on the numerical 1M x 50 rows
(after phase 17, before ranking), max_bin 256, AUC + logloss on the 100k
held-out rows:

24. lossguide at LightGBM's published settings (``LG_PARAMS``: 255
    leaves, no depth limit, eta 0.1) for 10 rounds through ``train``
    (``phase_lossguide``): kernel A 36 times a tree (the root and 35 steps
    of the top-8 queue, every step's child histograms at ``d = 0``,
    ``Kp = 0``, ``K = 16``), B 10, C and D never; held-out AUC rising; at
    most 255 leaves a tree and 255 in one; ``inplace_predict`` equal to
    ``predict``; the saved JSON, loaded back, within 1e-5; kernel B on the
    device-stacked forest against its plain version (its walk bound the
    deepest node + 1); kernel A on a real step's child histograms at
    ``K`` = 16 and (a 31-leaf tree) 2, bitwise equal to its plain version,
    timed beside ``index_add_`` and its bound;
25. lossguide at 31 and 255 leaves with sampling and a monotone
    constraint, 3 rounds on 64k rows on the card and on the CPU: the same
    trees;
26. DART at its tutorial's parameters (``DART_PARAMS``: depth 5, eta 0.1,
    uniform drops at 0.1, ``skip_drop`` 0.5) for 50 rounds
    (``phase_dart``): C once, D 250 times, A never, B at least 99 times
    (a training walk with the drops every round but the first, an eval
    walk every round); AUC rising; then 5 rounds at ``rate_drop`` 0.5 on
    the card and the CPU: the same trees and ``weight_drop``;
27. a random forest at its tutorial's parameters (``RF_PARAMS``: 100
    parallel trees of depth 5, learning rate 1, ``subsample`` and
    ``colsample_bynode`` 0.8) in one round (``phase_random_forest``): C
    once, D 500 times, B once; 100 trees, one round; the margins' AUC
    above one tree's; ``iteration_range=(0, 1)`` the whole model; 4
    parallel trees for 2 rounds on the card and the CPU: the same trees;
28. one round with ``sketch_eps``, ``sparse_threshold`` and ``predictor``
    set grows the same tree as without them, with a warning for each.

SHAP, the linear booster and the estimators, after the categorical
phases, back on the numerical 1M x 50 rows, max_bin 256, depth 6:

29. SHAP (``phase_shap``) on a 10-round main-path model: contributions of
    the 100k held-out rows summing to kernel B's margins within 1e-4, with
    no kernel launched but the one walk for those margins; Saabas
    additive; interactions on 10k rows summing to the contributions within
    1e-6 and symmetric; the card against the CPU (the same JSON, 4k rows,
    interactions on 1k) within 1e-9; the ms of contributions, interactions
    and the table builds; then a 3-class model (3 rounds, ``[n, 3, F+1]``),
    DART at its tutorial's parameters (tree weights) and the categorical
    configuration (its ``isin``), each additive and card == CPU; and the
    lossguide forest (255 leaves, no depth limit): additive, and with
    ``_TABLE_MAX_D`` at 8 its longer paths through the row DP, equal to
    the table path within 1e-8 (the path counts printed);
30. the linear booster (``phase_gblinear``): ``reg:squarederror`` on a
    linear target and ``binary:logistic``, 20 rounds with every updater
    and selector: the coefficients within 0.02 of the generator's, the
    held-out metric lower, no bins built and A = B = C = D = 0; ms a
    round; 5 rounds on 64k rows on the card and the CPU: weights within
    rtol 1e-6;
31. the estimators (``phase_sklearn``): ``XGBClassifier`` (10 trees,
    depth 6, max_bin 256, an eval set) grows ``train``'s trees with the
    main path's launches and ``predict_proba`` equals ``Booster.predict``;
    ``XGBRegressor(booster="gblinear").coef_``; ``XGBRanker`` on the 200k
    all-pairs ranking data; ``XGBRFClassifier`` (100 trees of depth 5 in
    one round); ``config_context(verbosity=0)`` silences the warnings of
    phase 28's keys.

The other tree methods and updater sequences: the refresh right after
phase 6, the rest after phase 31 (max_bin 256 unless named):

32. ``process_type="update"`` (``phase_refresh``): phase 6's 10-tree model
    refreshed on a second 1M sample of the generator with ``refresh_leaf``
    1 and 0, the held-out rows evaluated: A, C and D never, B for the
    walks; still 10 trees with new statistics (and leaves with 1); the
    cached eval margins equal to a fresh kernel B walk of the refreshed
    forest; the same model bytes on the card and the CPU on 64k rows; a
    standalone ``prune`` and an unknown updater raise;
33. ``tree_method="approx"`` (``phase_approx``) for 10 rounds: a matrix
    sketched from each round's hessians and its one-hot, so C 10, D 60
    (or A 60 on the construct route), B 10; held-out AUC >= 0.80 and
    rising; the sketch and its host prefix sum timed; card == CPU on 64k;
34. ``updater="grow_local_histmaker"`` (``phase_local``) for 5 rounds:
    per-node cuts on the card, kernel A at ``d = 0`` every level (A 30, C
    and D never); AUC >= 0.80 and rising; card == CPU on 64k rows;
35. ``tree_method="exact"`` (``phase_exact``) on Covertype-shaped rows
    (``_make_covtype``: UCI Covertype's 581,012 x 54, LIBSVM's
    ``covtype.binary`` label), B = 7,175 (int16), hoist plan 0: 5 rounds
    A 30, C and D never, the training logloss at or below a ``hist`` run's
    at max_bin 64; kernel A bitwise equal to plain at all 6 levels of a
    tree at this width; on 64k rows kernels C and D (a partial hoist of 18
    features) and A at every level (``phase_level_kernels``) and the card
    against the CPU (2 rounds; 3 until phase 44 joined);
36. kernel A's global-memory branch (``phase_wide_bins``): 1M x 8 with a
    column of 16,000 distinct values, B = 16,001 through
    ``compute_exact_cuts``, bitwise equal to plain at levels 0-5, timed
    beside ``index_add_`` and its byte bound.

Sparse input and external memory, after phase 36, max_bin 256, depth 6,
eta 0.1, AUC + logloss:

37. the Bosch-shaped CSR (``phase_sparse``, then ``phase_sparse_levels``:
    kernels D and A equal at every level of a tree at F = 968 and timed,
    the hoisted route against the construct route; Kaggle's Bosch Production
    Line Performance ``train_numeric.csv``: 1,183,747 x 968, about 19%
    stored, a few explicit zeros, a sparse linear label at Bosch's 0.58%
    failure rate; ``_make_bosch``) for 5 rounds with 100k held-out CSR
    rows: the CSR ``DMatrix`` and a dense NaN ``DMatrix`` of the same
    values, both on the card, give identical cuts, bins, trees (JSON) and
    predictions; the CSR matrix's dense ``data`` is never made through
    ``train`` + ``predict``; CSR ``inplace_predict`` equals dense; AUC
    rises; the ingest seconds, hoist plan, launches, round times and
    device and host memory printed;
38. the main path paged (``phase_external_memory``): the 1M x 50 rows fed
    by a ``DataIter`` of 8 batches into an ``ExternalMemoryQuantileDMatrix``
    in pages of 262,144 rows (4 pages, the last 213,568, 9 bits a bin, in
    a temporary directory) for 10 rounds: a ``StreamingQuantileDMatrix``
    of the same iterator has the same cuts and bins and grows the same
    trees; kernel A 240 launches, C and D none; AUC >= 0.80 and rising;
    the page-streamed margins within 1e-6 of the cached training margins;
    a 64k-row slice paged on the card and on the CPU grows the same trees;
    per page the read, copy and unpack ms, the prefetch wait, the bytes
    on disk and the device's peak memory against the streaming matrix's;
39. kernel A on every page at every level of that matrix's first tree
    (``phase_paged_levels``): bitwise its plain version, the pages' int64
    histograms summing to the whole matrix's, timed per page beside its
    bound, its plain version and one ``index_add_`` of the page's float
    gradients into the level's histogram.

Distributed training over ``torch.distributed`` (``phase_distributed``),
last, on the main path's 1M x 50 training and 100k held-out rows at the
reference-default parameters (max_bin 256, depth 6, eta 0.1, AUC and
logloss), every rank a child process (``torch.multiprocessing``, spawn)
that loads the kernels built above and trains inside ``mesh_context`` on
its own rows, the level histograms all-reduced as int64:

40. (1) world 2 over gloo on one card (staged through the host; not
    NCCL) on ragged shards, 600k / 400k training and 60k / 40k held-out
    rows, each rank binning through ``QuantileDMatrix(ref=)`` on the whole
    matrix's cuts: 10 rounds, both ranks' model bytes equal to phase 6's
    single-process model, per-round logloss within 1e-6 of it, AUC the
    weighted mean of the ranks' own, launches per rank C 1, D 60, A 0, B
    10, and 60 level all-reduces of the expected bytes; 3 rounds by the
    construct route (``XGBTPU_HOIST_BUDGET_MB=0``): A 18 per rank, C and D
    never, the hoisted run's first 3 trees; after each of those two runs
    (outside the counted window), every rank grows one tree's levels on
    its own rows and holds its route (D, then A) against the plain
    version bit for bit at every level before the all-reduce
    (``_dist_levels``); 10 rounds on the distributed
    sketch (no shared cuts): both ranks' cuts the merge of the two shards'
    summaries, held-out AUC rising and within 0.01 of the shared-cuts
    run's; (2) world 1 over NCCL, 3 rounds: phase 6's first 3 trees, every
    level's all-reduce an NCCL call on the card; (3) world 2 over NCCL
    where there are two cards (else a ``{"distributed_nccl_world2": "not
    run: 1 card"}`` line). Printed per rank: the median round, the
    histogram all-reduce ms per level (host clock between device
    synchronizations) and the bytes reduced per tree.

After phase 40 (max_bin 256 unless named):

41. the rounding repairs (``phase_rounding``): ``compute_cuts`` at max_bin
    100 and 1000 on 999,963 rows x 10 features with unit weights and on
    64k rows with hessian-like weights, the card's cuts bitwise the CPU's;
    the local histmaker's node totals at the main path's width (the 50
    features' 1M sorted weights, one node and 32), card == CPU bitwise,
    with their ms; the local histmaker at max_bin 100, 3 rounds on 64k
    rows, card == CPU trees, kernel A 6 times a tree;
42. lossguide under a row group (``phase_dist_lossguide``; its ranks run
    in phase 40's spawn): 255 leaves, no depth limit, 3 rounds over world
    2 (gloo, one card, 600k / 400k rows on shared cuts): both ranks' model
    bytes the single process's, kernel A 36 times a tree on each rank, B 3,
    C and D never, the recorded all-reduces and bytes per site a tree;
43. the main path traced (``phase_traced``): 10 rounds untraced, traced
    into a temporary directory (span trace and flight recorder), untraced,
    traced: the same trees and the same launches round by round, the JAX
    package's span names, 10 flight records; the median round traced and
    untraced and the last record printed. Then tracing's cost a round: 40
    pairs of adjacent rounds of one training run, one traced and one not,
    the median of the paired differences with its quartiles, beside the
    spans and records a round times their measured host cost;
44. crash-safe checkpoints and the resilience layer (``phase_resilience``):
    the main path at 12 rounds with ``resume_from``, one checkpoint a
    round. A straight run's bytes S; a worker process (this script with
    ``--resilience-worker``) SIGKILLed after round 5's ``after_iteration``
    (exit -9, its newest verified checkpoint 4 or 5 rounds) and the same
    command again: S, its launches C 1, D 6 a trained round, B an eval
    walk a trained round plus a fill walk a checkpointed round for each
    of its two caches; ``checkpoint_write`` chaos absorbed by the retry
    (``faults_total`` in the exposition), S; a ``pallas`` chaos hit at
    kernel B's wrapper (round 8's eval walk) raising out of ``train`` in a
    worker (a nonzero exit), its abort commit holding 8 rounds and a rerun
    giving S; a ``round_dispatch`` watchdog deadline of 2 ms from round 6
    on raising ``WatchdogTimeout``, the abort commit holding the rounds
    before it and a resume giving S. Printed: the checkpoint's cost a
    round, the payload bytes, the resume's load + verify, parse and fill
    ms, the median round with and without ``resume_from``;
45. elastic training (``phase_elastic``): the main path (1M x 50, max_bin
    256, depth 6, eta 0.1, 10 rounds, a checkpoint a round, heartbeats
    every 0.25 s) through ``elastic_train``, each rank this script with
    ``--elastic-worker`` on the one card over gloo. (a) 2 -> 1: blocks of
    500,000 rows, rank 1 SIGKILLed at its 5th round boundary, the
    survivor shrinking to one in its process; (b) 3 -> 2: blocks of
    333,334 / 333,333 / 333,333, rank 2 killed, both survivors restarting
    their process images. Every survivor's model bytes == a straight
    single-process run on the card; each generation's hoist plan and the
    survivors' launches printed (a: C 2, B a fill walk a resumed round, D
    60 and the levels of the round in flight), with the seconds from the
    SIGKILL to the survivor's raise and to its heartbeat verdict beside
    ``hb_deadline()``, from the raise to the first replayed round, the
    rounds replayed, the median round at world 2 and at world 1, and in
    (b) the seconds from the resize to the restarted image's first flight
    line and first round;
46. the command line (``phase_cli``): ``python -m xgboost_tpu_torch`` with
    config files on the card: ``train`` (10 rounds on the first 100,000
    main-path rows written as libsvm; 200,000 before phase 48 came),
    ``pred`` (the first 50,000 held-out rows) and ``dump``, the predictions == ``Booster.predict`` on the card
    digit for digit and the dump == ``get_dump()``; ``obs-report`` on
    phase 45 (a)'s run directory (2 ranks, the elastic events, its
    replayed rounds) and ``checkpoint-inspect`` on its checkpoints (the
    newest verified, 10 rounds, marked).
47. serving (``phase_serving``, last): the reference-default model (1M x
    50, max_bin 256, depth 6, 10 rounds) saved as JSON and served on the
    card. (a) ``inplace_predict`` of the 100k held-out rows (through
    ``predict_serving``) == ``Booster.predict`` margins of a fresh
    ``DMatrix`` == kernel B's plain version on CPU copies, bit for bit,
    and kernel B's ``kernel_ms`` at 16 and 4,096 rows beside its bound
    (taken right after phase 5 trains the model, where ``torch.profiler``
    still keeps kernel B's records);
    (b) ``bench.py``'s latency sweep (1/16/256/4096 rows, medians of
    30/8) and in-place against DMatrix-path rows/s on the 100k rows; (c)
    ``bench.py``'s concurrent stream (8 client threads, 400 requests of
    1-64 rows from seed 11, ``batch_wait_us=500``) interleaved with the
    same stream run sequentially x5 (means), every response ==
    ``inplace_predict`` of its rows bit for bit, kernel B launches ==
    coalesced dispatches, the coalescing ratio and the SLO stage p50/p99;
    (d) a hot swap mid-stream to the same model continued for 10 rounds:
    no request lost, every response one model's bits or the other's; (e)
    scripted ``pallas`` faults on served dispatches: a transient one
    retried and served, a permanent one a typed ``RequestError``, no
    plain walk, the breaker's state printed; (f) ``python -m
    xgboost_tpu_torch serve --stdin``: load, a predict of 1,000 rows and
    ``stats``, the answers == ``inplace_predict`` digit for digit; (g),
    run after (c): where a served dispatch's time goes (its predict and
    the rest, medians, with the clients active and parked, against the
    same predicts in turn from one thread) and the lock releases, metric
    registry lookups and torch calls one served request costs on each
    thread.
48. the serving fleet (``phase_fleet``, after 47): the same model saved
    as JSON and served as ``m`` and ``m2`` by ``python -m
    xgboost_tpu_torch serve-fleet --replicas 2 --batch-wait-us 500`` on
    the card. (a) READY, ``fleet.json`` with 2 replicas alive, each
    replica's seconds from spawn to READY, and only the replicas on the
    card: ``nvidia-smi``'s compute apps list them and not the fleet's own
    process (or, where it lists another pid namespace, one more app a
    replica), and the fleet's process holds no ``/dev/nvidia*`` file; (b)
    phase 47's stream (8 threads, 400 requests of 1-64 rows, seed 11)
    through the router, one connection a thread, ``m`` and ``m2``
    alternating, two tenants, every answer == ``inplace_predict`` bit for
    bit, the rows/s of 3 passes beside phase 47's one server and its
    sequential stream, the same stream straight to one replica, and the
    parse and re-encode of a request line (the router's work on one
    interpreter lock); (c) SIGTERM to the hash owner of ``m`` a quarter
    into a pass, (d) SIGKILL to the other replica likewise: the clients
    stream on until the respawn serves, none lost, every answer's bits
    kept, ``fleet_reroutes_total`` risen, the respawn a new pid of a
    higher generation started without ``--model`` and serving ``m`` and
    ``m2`` from the manifest, the seconds from the signal to its READY;
    (g) SIGTERM to the fleet: exit 0, no replica left; (e) every dispatch
    record and access line of every replica generation on route
    ``kernel`` (kernel B), the dispatches per replica (kernel B's
    launches there) and their p50 / p99; (f) ``serve-report`` on the
    fleet directory (``fleet serve-report (2 replicas)``, the per-replica
    rollup with the drain, the per-tenant rollup, the merged trace with
    both replicas) and ``obs-report`` folding in both replicas.
49. the pipelined round loop (``phase_pipeline``, after 48) on the main
    path (1M x 50, max_bin 64, depth 6, eta 0.1, the hoisted route). (a)
    20 consumer-free rounds (no eval set) at ``XGBTPU_PIPELINE_DEPTH`` 0
    and 2 in turns, 3 runs each, after one untimed round (the binning and
    kernel C's one-hot): equal ``save_raw()`` bytes, the flight ``sync``
    stage above 0 at depth 2, launches C 1, D 6 a round, A and B none;
    the host ms a round (the run's wall time over its rounds, the device
    synchronised at the end) and ``torch.cuda.max_memory_allocated`` of
    each depth; the host syncs of one consumer-free round listed by
    ``torch.cuda.set_sync_debug_mode("warn")``. (c) 10 rounds with the
    100k held-out eval and a checkpoint a round, async
    (``XGBTPU_ASYNC_CKPT=1``) and synchronous in turns (async, sync, sync,
    async): every run's checkpoint files byte-equal; the median round
    (flight records' wall time) and a checkpoint's ms on the loop's thread
    (``_AtomicCheckpoint._save``) of each; S, the runs' bytes. (b) The
    same run with a scripted ``pipeline_sync`` fault at round 5's wait:
    it raises with ``.pipeline_round`` 5 and one ``pipeline_fault`` flight
    event, the abort commits 6 rounds, and the resume gives S; (b) and
    (c) launch D 6 a trained round, B one eval walk a trained round and
    the resume's fill walks (2 a committed round), C and A none. (d)
    ``XGBTPU_OBSERVER`` on 2 rounds: the JAX package's 6 file names
    (``00000_grad.npy`` ...), their sums printed.
50. the C API and the native host runtime (``phase_c_api``, after 49) on
    the main path (1M x 50, max_bin 64, depth 6, eta 0.1, AUC + logloss on
    the 100k held-out rows, 10 rounds), ``XGBTPU_DEVICE`` unset (the card).
    (a) ``g++`` builds ``native/{fastparse,pagecache,c_api}.cpp`` (seconds
    and paths printed). (b) Through ``ctypes`` in this process:
    ``XGDMatrixCreateFromMat`` + ``XGDMatrixSetFloatInfo`` for both row
    sets, ``XGBoosterCreate`` over both, ``XGBoosterSetParam`` a key (a
    call a metric), 10 rounds of ``XGBoosterUpdateOneIter`` +
    ``XGBoosterEvalOneIter``, ``XGBoosterPredict`` on the eval set and
    ``XGBoosterSaveModelToBuffer``, each round in turns with the same round
    through the Python API (``Booster``, ``update``, ``eval_set``, then
    ``predict``, ``save_raw``): equal model bytes, predictions bit for bit
    and eval strings; AUC >= 0.80 and rising; the C API's launches C 1, D
    60, A 0, B >= 10; the ms a round of each (medians). (c) A C program
    (``C_HOST_TRAIN``, ``gcc`` against the library) reads the same rows
    from raw float32 files and trains the same 10 rounds on the card: exit
    0, its model bytes and predictions equal (b)'s, its last eval string
    (b)'s; the seconds to its first handle and first finished round and
    its ms a round. (d) ``XGDMatrixCreateFromFile`` on libsvm files of
    phase 46's shape (100,000 and 50,000 rows): the native parser's arrays
    equal the plain Python parser's and the rows themselves, the handle's
    shape and labels too, and the (b) model predicts the same on the
    file's handle as on the plain parser's rows; both parse times. (e) Phase
    39's page reads, now through ``pagecache.cpp``'s ring: the read wait and
    copy a page beside the numpy reads' (~2.95 ms wait, 2.5-2.9 ms copy).
51. the per-level grow profiler and the perf ledger (``phase_kernelprof``,
    after 50) on the main path's data (1M x 50, depth 6, eta 0.1, AUC +
    logloss on the 100k held-out rows, 10 rounds), each run on a fresh
    matrix with ``XGBTPU_KERNEL_PROF`` unset and then ``every=1``: (a)
    max_bin 64 (the full hoist, kernel D), (b) the construct route
    (``XGBTPU_HOIST_BUDGET_MB=0``, kernel A), (c) max_bin 256 (the partial
    hoist, D). Each: model bytes equal with and without the profiler;
    launches equal and C 1 (hoisted), D or A 6 a round, B 1 a round; none
    of B's or C's inside a bracket (the bracket wrapped to count them); a
    ``grow_detail`` a round with 16 brackets, ``level_hist`` ``cuda:D`` or
    ``cuda:A``, the other ops ``torch``; the per-op, per-depth medians of
    rounds 1-9 (wall, host, in-flight, gap ms) and the coverage ``sum_s /
    stages.grow`` with the rest of ``stages.grow`` (gaps, and outside the
    brackets), beside the unprofiled run's median ``stages.grow``. (d)
    ``grow-report`` of (a)'s flight sink and ``--diff`` (a) (b)
    (``cuda:D->cuda:A``), ``trace-report`` of (a)'s trace with its
    ``grow`` breakdown, ``perf-report`` on the repository's banks: each
    exits 0. (e) The host syncs of an unprofiled round
    (``set_sync_debug_mode``): round 2 of a ``train`` after profiled rounds
    0-1 equal to the profiler off, and phase 49's all among them.
52. kernel S, the strict-order scan of split evaluation (``phase_scan``,
    after 51): (a) ``seq_cumsum`` on ``[2, K, F, 256]`` normals, the two
    scans of a level at depths 0-5 for F = 50 and 136, and at B = 7,175
    and 16,001, bit for bit the plain loop's on the card; each timed as
    phase 8 times the others (wrapper ``ms``, ``kernel_ms``, the plain
    loop's ms, ``torch.cumsum`` as the library yardstick, which the port
    never calls) beside its byte bound. (b) The rows of the benchmark's
    ``synth-binary.1m-bin256`` cell (``portbench/traffic.py``, one seed)
    through ``QuantileDMatrix``, 10 rounds of its parameters with the
    held-out logloss: runs with kernel S and with the plain loop put in
    its place, in turns (kernel, plain, plain, kernel), give the same
    model bytes; kernel S launches 12 a tree, the plain loop none; a run
    under ``XGBTPU_KERNEL_PROF=every=1`` gives the same bytes and reads
    impl ``cuda:S`` on every ``level_update/scan`` record (2 a depth);
    the ms a round after round 0 of each run, and the profiled rounds'
    host ms of the scans.

The data generator is ``bench.py:_make_data``, copied. The last line is
``{"ok": true, "device": {...}}``; the line before it is the card's name and
power limit; before that, one JSON line lists the kernels.
"""

import contextlib
import hashlib
import json
import os
import pickle
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

import xgboost_tpu_torch as xgbt
from xgboost_tpu_torch import _build, threefry
from xgboost_tpu_torch import predictor as predictor_mod
from xgboost_tpu_torch.gbm.gbtree import _cat_cfg
from xgboost_tpu_torch.metric import create_metric
from xgboost_tpu_torch.objective import create_objective
from xgboost_tpu_torch.observability import REGISTRY
from xgboost_tpu_torch.params import TrainParam
from xgboost_tpu_torch.data import external as xext
from xgboost_tpu_torch.data.quantile import _sequential_cdf
from xgboost_tpu_torch.predictor import (_predict_margin_plain,
                                         forest_from_numpy, predict_margin,
                                         stack_forest, walk_row_chunks)
from xgboost_tpu_torch.tree import grow_lossguide as glg
from xgboost_tpu_torch.tree import hist_kernel as hk
from xgboost_tpu_torch.tree.grow import (GrowParams, apply_row_sampling,
                                         mvs_sample)
from xgboost_tpu_torch.tree.grow_fused import _init_state, _level_update
from xgboost_tpu_torch.tree.grow_lossguide import lossguide_steps
from xgboost_tpu_torch.tree.param import SplitParams

DEVICE = torch.device("cuda")
ROWS, COLS, EVAL_ROWS, MAX_BIN, DEPTH, ROUNDS = 1_000_000, 50, 100_000, 64, 6, 10
DEFAULT_MAX_BIN = 256
CPU_ROWS, CPU_ROUNDS = 65_536, 3
# the card-vs-CPU runs of the ranking, 7-class and exact phases, cut from
# CPU_ROUNDS to keep the script's length as phase 44 joined it
CUT_CPU_ROUNDS = 2
TIMING_REPS = 20
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, non-tensor 32-bit op/s,
# dense int8 tensor-core op/s
PEAK_BYTES = 3.35e12
PEAK_OPS = 67e12
PEAK_INT8 = 1979e12
METRICS = {"eval_metric": ["auc", "logloss"]}
PARAMS = {"objective": "binary:logistic", "tree_method": "tpu_hist",
          "max_depth": DEPTH, "max_bin": MAX_BIN, "eta": 0.1, **METRICS}
# bench.py's reference-default run: max_bin and max_depth left at their
# defaults (256 and 6)
PARAMS_DEFAULT = {"objective": "binary:logistic", "eta": 0.1, **METRICS}
HEAP_FIELDS = ("keep", "feature", "split_bin", "split_cond", "default_left",
               "leaf_value")
ALLOC_FIELDS = ("left", "right", "n_nodes", "depth_max")
# (column, categories) of the categorical configuration: fewer than
# max_cat_to_onehot (4) categories split one-hot, the rest by partition
CAT_COLUMNS = ((0, 3), (1, 3), (10, 32), (11, 32), (12, 32), (40, 200),
               (41, 200), (42, 200))
ONEHOT_COLUMNS = (0, 1)
# kernel B's past-the-bound walk: X holds just over this many elements
ELEMS_2_31 = 1 << 31


def _make_data(rows: int, cols: int, sparsity: float, seed: int = 42):
    """``(X, y, w)``: the rows, their labels and the generator's weights
    (the label is ``X @ w * 0.5`` plus unit noise, thresholded at 0)."""
    rng = np.random.RandomState(seed)
    X = rng.randn(rows, cols).astype(np.float32)
    if sparsity > 0:
        X[rng.rand(rows, cols) < sparsity] = np.nan
    w = rng.randn(cols).astype(np.float32)
    logits = np.nan_to_num(X) @ w * 0.5
    y = (logits + rng.randn(rows).astype(np.float32) > 0).astype(np.float32)
    return X, y, w


def _make_cat_data(rows: int, cols: int, seed: int = 42):
    """``_make_data(rows, cols, 0.0, seed)``'s draws, then from the same
    stream, for each of ``CAT_COLUMNS``: integer codes replacing the
    column, their effect added to the logits, and 5% of the column set
    missing. The effects are a table per column drawn from ``seed + 1``
    (normal, scale 1.5: not monotone in the code, and the same tables at
    any row count). Returns ``(X, y, feature_types)``."""
    rng = np.random.RandomState(seed)
    X = rng.randn(rows, cols).astype(np.float32)
    w = rng.randn(cols).astype(np.float32)
    logits = np.nan_to_num(X) @ w * 0.5
    noise = rng.randn(rows).astype(np.float32)
    tables = np.random.RandomState(seed + 1)
    for c, k in CAT_COLUMNS:
        effect = (tables.randn(k) * 1.5).astype(np.float32)
        codes = rng.randint(0, k, rows)
        logits += effect[codes]
        X[:, c] = codes
        X[rng.rand(rows) < 0.05, c] = np.nan
    y = (logits + noise > 0).astype(np.float32)
    types = ["q"] * cols
    for c, _ in CAT_COLUMNS:
        types[c] = "c"
    return X, y, types


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def time_ms(fn, reps: int = TIMING_REPS, warmup: int = 3) -> float:
    """Median device time of one call, by CUDA events around each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


#: substrings of the kernel names that each wrapper launches (the device
#: operations that ``kernel_ms`` sums)
KERNEL_KEYS = {"A": ("level_",), "B": ("walk_kernel",), "C": ("onehot",),
               "D": ("route_kernel", "hoisted_kernel"),
               "A_route": ("level_route_kernel",),
               "D_route": ("route_kernel",), "S": ("seq_scan",)}
#: CUDA launches per wrapper call (A and D: the routing launch and the
#: histogram launch; one level each)
KERNEL_LAUNCHES = {"A": 2, "B": 1, "C": 1, "D": 2, "A_route": 1,
                   "D_route": 1, "S": 1}


def _profiled_ms(prof, kernel: str, calls: int):
    """The device time per call of ``kernel`` in ``prof`` over ``calls``
    calls: the mean of its launch records times ``KERNEL_LAUNCHES``. The
    profiler can drop records late in a long run (on the H100, 19 of 20
    kept, at worst 8), so a sum over the records would read low; the
    shortfall is printed. None if it saw none, or more launches than the
    calls make."""
    ev = [e for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and any(k in e.key for k in KERNEL_KEYS[kernel])]
    seen = sum(e.count for e in ev)
    want = calls * KERNEL_LAUNCHES[kernel]
    if seen != want:
        print(f"  profiler: kernel {kernel}: {seen} of {want} launch records")
    if not seen or seen > want:
        return None
    us = sum(e.self_device_time_total for e in ev)
    return us / seen * KERNEL_LAUNCHES[kernel] / 1e3


def kernel_ms(fn, kernel: str, reps: int = TIMING_REPS):
    """The kernel's own device time per call: ``torch.profiler``'s device
    time of the kernels named in ``KERNEL_KEYS[kernel]`` over ``reps``
    calls of ``fn`` (``_profiled_ms``), without the wrapper's other device
    operations and host gaps."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return _profiled_ms(prof, kernel, reps)


def bound_ms(nbytes: float, nops: float, peak_ops: float = PEAK_OPS):
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, nops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def level_bounds(n: int, F: int, Fh: int, B: int, bs: int, lvl: int):
    """``(bound_ms, bound_by)`` of kernel D (``Fh`` features hoisted) and of
    kernel A at level ``lvl`` of ``n`` rows of ``F`` features of ``bs``-byte
    bins: each reads its bins (D the one-hot and the unhoisted bins), the
    positions, q and the table once and writes positions and the int64
    histogram once; D's int8 products count 2 x 8K x the one-hot's
    elements, A's two operations per bin."""
    K, Kp = 1 << lvl, (1 << lvl) >> 1
    onehot = Fh * B * hk.onehot_rows(n)
    small = n * 4 + n * 8 + Kp * 16 + n * 4 + F * 2 * K * B * 8
    d_bytes = onehot + n * (F - Fh + 1) * bs + small
    return (bound_ms(d_bytes, 2 * 8 * K * onehot, PEAK_INT8),
            bound_ms(n * F * bs + small, 2 * n * F))


def _index_add_ms(bins, local, grad, hess, K: int, B: int,
                  reps: int = TIMING_REPS):
    """The library yardstick of kernel A: one ``index_add_`` of float g and
    h into the flat ``[F*2K*B]`` histogram at the cells of the rows at
    local nodes ``local`` ([n], -1: none), missing excluded."""
    F = bins.shape[1]
    b = bins.long()
    keep = ((local >= 0) & (local < K))[:, None] & (b < B)
    cell = ((torch.arange(F, device=DEVICE)[None, :] * 2 * K
             + local[:, None]) * B + b)[keep]
    rows = torch.nonzero(keep)[:, 0]
    idx = torch.cat([cell, cell + K * B])
    vals = torch.cat([grad[rows], hess[rows]])
    flat = torch.zeros(F * 2 * K * B, dtype=torch.float32, device=DEVICE)
    return time_ms(lambda: flat.index_add_(0, idx, vals), reps=reps)


def reset_launches() -> None:
    for fn in (hk.fused_level, hk.hoisted_level, hk.build_onehot,
               predict_margin):
        fn.launches = 0


def launches() -> dict:
    return {"A": hk.fused_level.launches, "B": predict_margin.launches,
            "C": hk.build_onehot.launches, "D": hk.hoisted_level.launches}


def heap_trees(bst, count: int):
    """The first ``count`` device-grown trees' arrays, on the host, with
    their category sets where they were grown on categories, and the
    explicit children and node count of lossguide (allocation-ordered)
    trees."""
    out = []
    for e in bst._gbm.model._entries[:count]:
        fields = HEAP_FIELDS + (("cat_set",) if e.cat_set is not None else ())
        if hasattr(e, "left"):
            fields += ALLOC_FIELDS
        out.append({f: getattr(e, f).cpu().numpy() for f in fields})
    return out


def same_trees(a, b, what: str) -> None:
    check(len(a) == len(b), f"{what}: tree counts {len(a)} vs {len(b)}")
    for t, (x, y) in enumerate(zip(a, b)):
        check(x.keys() == y.keys(), f"{what}: tree {t} fields")
        for f in x:
            check(np.array_equal(x[f], y[f]), f"{what}: tree {t} {f}")


def phase_build():
    t0 = time.perf_counter()
    _build.build_all()
    for name in _build.SOURCES:
        _build.library(name)
    print(f"build: {time.perf_counter() - t0:.2f} s for "
          f"{sorted(_build.SOURCES)}")
    for name, rec in sorted(_build.build_log.items()):
        lines = [ln for ln in rec["log"].splitlines()
                 if "registers" in ln or "smem" in ln or "bytes stack" in ln]
        for ln in lines:
            print(f"  ptxas[{name}]: {ln.strip()}")


def _mean(levels, key):
    return sum(x[key] for x in levels) / len(levels)


def phase_onehot_kernel(bins, B: int, Fh: int):
    """Kernel C against its plain version: bitwise, timed."""
    n = bins.shape[0]
    got = hk._build_onehot_cuda(bins, B=B, Fh=Fh)
    want = hk._build_onehot_plain(bins, B=B, Fh=Fh)
    torch.cuda.synchronize()
    check(torch.equal(got, want), f"one-hot B={B} Fh={Fh}: kernel == plain")
    del want
    ms = time_ms(lambda: hk.build_onehot(bins, B=B, Fh=Fh))
    k_ms = kernel_ms(lambda: hk.build_onehot(bins, B=B, Fh=Fh), "C")
    plain_ms = time_ms(lambda: hk._build_onehot_plain(bins, B=B, Fh=Fh),
                       reps=5, warmup=1)
    nbytes = n * Fh * bins.element_size() + got.numel()
    bnd, by = bound_ms(nbytes, n * Fh * B)
    print(f"kernel C (B={B}, Fh={Fh}, {n} rows, {got.numel() / 1e9:.2f} GB): "
          f"{ms:.4f} ms (kernel alone {k_ms} ms)  plain {plain_ms:.4f} ms  "
          f"bound {bnd:.4f} ms ({by})  bitwise equal")
    return got, dict(ms=ms, kernel_ms=k_ms, plain_ms=plain_ms,
                     library_ms=None, bound_ms=bnd, bound_by=by,
                     max_abs_err=0.0, B=B, Fh=Fh)


def _int_mm_ms(M: int, onehot):
    """The library yardstick of kernel D: one ``torch._int_mm`` of an
    [M, n_pad] int8 channel matrix by the [n_pad, Fh*B] one-hot (the
    product only). None, with the reason printed, where it refuses."""
    chan = torch.zeros((M, onehot.shape[1]), dtype=torch.int8, device=DEVICE)
    try:
        return time_ms(lambda: torch._int_mm(chan, onehot.t()))
    except RuntimeError as e:
        print(f"  torch._int_mm refused [{M}, {onehot.shape[1]}] x "
              f"[{onehot.shape[1]}, {onehot.shape[0]}]: {e}")
        return None


def phase_level_kernels(d, max_bin: int, objective="binary:logistic",
                        prefix="", rows_10m=False, binned=None):
    """Kernels C, D and A at every level of a real tree, for one max_bin,
    on ``d``'s bins (or ``binned``, a matrix of ``d`` at width
    ``max_bin``) and ``objective``'s gradients at margin 0 (within ``d``'s
    query groups, if any); ``rows_10m`` adds kernel A at 10M rows
    (``phase_construct_10x``)."""
    dev = DEVICE
    if binned is None:
        binned = d.get_binned(max_bin)
    bins, cuts = binned.bins, binned.cut_values
    bins_t = binned.feature_major()
    n, F = bins.shape
    B = max_bin
    Fh = hk.hoist_plan(hk.onehot_rows(n), F, B, dev)
    check(Fh > 0, f"max_bin {B}: hoist plan {Fh}")
    onehot, c_stats = phase_onehot_kernel(bins, B, Fh)
    obj = create_objective(objective)
    grad, hess = obj.get_gradient(torch.zeros(n, device=dev), d.label, None,
                                  groups=d.groups)
    gq = hk.quantize_gradients(grad, hess)
    cfg = GrowParams(max_depth=DEPTH, split=SplitParams())
    st = _init_state(cfg, gq.totals())
    pos = torch.zeros((n, 1), dtype=torch.int32, device=dev)
    bs = bins.element_size()
    a_levels, d_levels = [], []
    tables = []  # (pos, ptab) of each level, for the 10M x 50 check
    for lvl in range(DEPTH):
        K, Kp = 1 << lvl, (1 << lvl) >> 1
        kw = dict(K=K, Kp=Kp, B=B, d=lvl)
        pd, hd = hk._hoisted_level_cuda(bins, onehot, pos, gq, st.ptab, **kw)
        pd2, hd2 = hk._hoisted_level_cuda(bins, onehot, pos, gq, st.ptab, **kw)
        pa, ha = hk._fused_level_cuda(bins, pos, gq, st.ptab, bins_t=bins_t,
                                      **kw)
        pa2, ha2 = hk._fused_level_cuda(bins, pos, gq, st.ptab, **kw)
        pdp, hdp = hk._hoisted_level_plain(bins, onehot, pos, gq, st.ptab, **kw)
        pap, hap = hk._fused_level_plain(bins, pos, gq, st.ptab, **kw)
        torch.cuda.synchronize()
        tag = f"{prefix}B={B} level {lvl}"
        for name, (p_, h_) in (("D", (pd, hd)), ("D again", (pd2, hd2)),
                               ("A", (pa, ha)), ("A again", (pa2, ha2)),
                               ("D plain", (pdp, hdp))):
            check(torch.equal(p_, pap), f"{tag}: pos {name} == plain")
            check(torch.equal(h_, hap), f"{tag}: int64 hist {name} == plain")
        pr, rec, unhoisted = hk._channel_records_cuda(bins, pos, gq, st.ptab,
                                                      Fh=Fh, **kw)
        want_rec = hk._channel_records_plain(pap, gq, K=K, d=lvl)
        torch.cuda.synchronize()
        check(torch.equal(pr, pap) and torch.equal(rec, want_rec),
              f"{tag}: D's routing launch: pos and records == plain")
        check(unhoisted is None if Fh == F else
              torch.equal(unhoisted[:, :n], bins[:, Fh:].t()),
              f"{tag}: D's routing launch: unhoisted bins feature-major")
        pr, loc = hk._level_records_cuda(bins, pos, gq, st.ptab, **kw)
        want_loc = hk._level_records_plain(pap, K=K, d=lvl)
        torch.cuda.synchronize()
        check(torch.equal(pr, pap) and torch.equal(loc, want_loc),
              f"{tag}: A's routing launch: pos and records == plain")
        del pd2, hd2, pa2, ha2, pdp, hdp, pap, hap, pr, rec, want_rec, loc
        del want_loc, unhoisted
        lane = (torch.arange(2 * K, device=dev) >= K).long()[None, :, None]
        hist = gq.dequantize(hd, lane)
        check(torch.equal(hist, gq.dequantize(ha, lane)),
              f"{tag}: f32 hist D == A")

        tables.append((pos, st.ptab.clone()))
        d_ms = time_ms(lambda: hk.fused_level(bins, pos, gq, st.ptab,
                                              onehot=onehot, **kw))
        d_kms = kernel_ms(lambda: hk.fused_level(bins, pos, gq, st.ptab,
                                                 onehot=onehot, **kw), "D")
        d_plain = time_ms(lambda: gq.dequantize(hk._hoisted_level_plain(
            bins, onehot, pos, gq, st.ptab, **kw)[1], lane), reps=5, warmup=1)
        a_ms = time_ms(lambda: hk.fused_level(bins, pos, gq, st.ptab,
                                              bins_t=bins_t, **kw))
        a_kms = kernel_ms(lambda: hk.fused_level(bins, pos, gq, st.ptab,
                                                 bins_t=bins_t, **kw), "A")
        a_plain = time_ms(lambda: gq.dequantize(hk._fused_level_plain(
            bins, pos, gq, st.ptab, **kw)[1], lane), reps=5, warmup=1)
        # library yardsticks: _int_mm of D's product (M = 8K channel rows,
        # at least 32 for _int_mm's size rule); one index_add_ of float g/h
        # into the flat [F*2K*B] histogram at this level's cells for A
        M = max(32, -(-8 * K // 16) * 16)
        d_lib = _int_mm_ms(M, onehot)
        a_lib = _index_add_ms(bins, pd[:, 0].long() - ((1 << lvl) - 1),
                              grad, hess, K, B)
        (d_bnd, d_by), (a_bnd, a_by) = level_bounds(n, F, Fh, B, bs, lvl)
        d_levels.append(dict(level=lvl, ms=d_ms, kernel_ms=d_kms,
                             plain_ms=d_plain, library_ms=d_lib,
                             bound_ms=d_bnd, bound_by=d_by))
        a_levels.append(dict(level=lvl, ms=a_ms, kernel_ms=a_kms,
                             plain_ms=a_plain, library_ms=a_lib,
                             bound_ms=a_bnd, bound_by=a_by))
        lib_s = "refused" if d_lib is None else f"{d_lib:.4f} ms"
        print(f"{tag} (K={K}): kernel D {d_ms:.4f} ms (alone {d_kms} ms)  "
              f"plain {d_plain:.4f} ms  _int_mm {lib_s}  bound {d_bnd:.4f} ms "
              f"({d_by}) | kernel A {a_ms:.4f} ms (alone {a_kms} ms)  plain "
              f"{a_plain:.4f} ms  index_add_ "
              f"{a_lib:.4f} ms  bound {a_bnd:.4f} ms ({a_by}) | bitwise equal")
        st = _level_update(st, hist, cuts, cfg, lvl)
        pos = pd
    del onehot
    torch.cuda.empty_cache()
    big = (phase_construct_10x(bins, bins_t, gq, tables, B) if rows_10m
           else None)
    del tables

    def summary(levels):
        libs = [x["library_ms"] for x in levels]
        kms = [x["kernel_ms"] for x in levels]
        return dict(ms=_mean(levels, "ms"),
                    kernel_ms=None if None in kms else sum(kms) / len(kms),
                    plain_ms=_mean(levels, "plain_ms"),
                    library_ms=(None if None in libs
                                else sum(libs) / len(libs)),
                    bound_ms=_mean(levels, "bound_ms"),
                    bound_by=levels[-1]["bound_by"], max_abs_err=0.0,
                    levels=levels)

    a_sum = summary(a_levels)
    if big is not None:
        a_sum["rows_10m"] = big
    return c_stats, a_sum, dict(summary(d_levels), B=B, Fh=Fh)


def phase_construct_10x(bins, bins_t, gq, tables, B: int):
    """Kernel A where the hoist plan itself picks it: the 1M x 50 bins, q
    and positions repeated 10 times (10M x 50), through each level's table
    of the 1M tree. The int64 histogram must be 10 x the 1M one and the
    positions the 1M ones repeated; no plain run at 10M."""
    reps = 10
    n, F = bins.shape
    plan = hk.hoist_plan(hk.onehot_rows(reps * n), F, B, DEVICE)
    check(plan == 0, f"10M x {F} bin {B}: hoist plan {plan}, want 0")
    big_bins = bins.repeat(reps, 1)
    big_bins_t = hk.feature_major(big_bins)
    big_gq = hk.QuantizedGradients(q=gq.q.repeat(reps, 1), exp=gq.exp)
    levels = []
    for lvl, (pos, ptab) in enumerate(tables):
        K, Kp = 1 << lvl, (1 << lvl) >> 1
        kw = dict(K=K, Kp=Kp, B=B, d=lvl)
        big_pos = pos.repeat(reps, 1)
        p1, h1 = hk._fused_level_cuda(bins, pos, gq, ptab, bins_t=bins_t, **kw)
        p10, h10 = hk._fused_level_cuda(big_bins, big_pos, big_gq, ptab,
                                        bins_t=big_bins_t, **kw)
        torch.cuda.synchronize()
        check(torch.equal(p10, p1.repeat(reps, 1)),
              f"10M level {lvl}: pos == the 1M pos repeated")
        check(torch.equal(h10, h1 * reps), f"10M level {lvl}: hist == 10 x 1M")
        del p1, h1, p10, h10
        run = lambda: hk.fused_level(big_bins, big_pos, big_gq, ptab,  # noqa: E731
                                     bins_t=big_bins_t, **kw)
        ms = time_ms(run)
        k_ms = kernel_ms(run, "A")
        N = reps * n
        nbytes = (N * F * bins.element_size() + N * 4 + N * 8 + Kp * 16
                  + N * 4 + F * 2 * K * B * 8)
        bnd, by = bound_ms(nbytes, 2 * N * F)
        print(f"10M x {F} bin {B} level {lvl} (K={K}, hoist plan 0): kernel A"
              f" {ms:.4f} ms (alone {k_ms} ms)  bound {bnd:.4f} ms ({by})  "
              f"== 10 x the 1M hist")
        levels.append(dict(level=lvl, ms=ms, kernel_ms=k_ms, bound_ms=bnd,
                           bound_by=by))
        del big_pos
    return levels


def _random_forest(rng, T, depth, F, G=1):
    """T random depth-``depth`` heap trees over F features; tree ``t`` in
    group ``t % G`` (the interleaved ``tree_info`` of a K-class model)."""
    N = (1 << (depth + 1)) - 1
    internal = (1 << depth) - 1
    idx = np.arange(N)
    left = np.where(idx < internal, 2 * idx + 1, -1)
    right = np.where(idx < internal, 2 * idx + 2, -1)
    left, right = np.tile(left, (T, 1)), np.tile(right, (T, 1))
    feature = rng.randint(0, F, size=(T, N))
    cond = np.where(left >= 0, rng.randn(T, N) * 0.7,
                    rng.randn(T, N) * 0.1).astype(np.float32)
    default_left = rng.rand(T, N) < 0.5
    return forest_from_numpy(left, right, feature, cond, default_left,
                             np.arange(T) % G, depth, G, device=DEVICE,
                             heap_layout=True)


#: kernel B's shapes: (trees, rows); T = 1 is each round's eval walk, T = 10
#: the forest this phase has always timed, T = 500 a bench.py-sized model
WALK_SHAPES = ((1, EVAL_ROWS), (10, EVAL_ROWS), (500, EVAL_ROWS),
               (500, ROWS))
# the plain walk runs on at most this many rows (rows are independent)
WALK_PLAIN_ROWS = 10_000


def walk_need(forest, X):
    """``(bytes of X, node tests)`` that the walk of ``forest`` over ``X``
    needs: 4 bytes per distinct (row, feature) that some tree's path
    tests, and one test per split node on each row's path in each tree
    (a bound counts what this data needs, not all of X nor ``max_depth``
    steps for every tree)."""
    n = X.shape[0]
    rows = torch.arange(n, device=X.device)
    seen = torch.zeros(X.shape, dtype=torch.bool, device=X.device)
    tests = torch.zeros((), dtype=torch.int64, device=X.device)
    for t in range(forest.num_trees):
        node = torch.zeros(n, dtype=torch.int64, device=X.device)
        for _ in range(forest.max_depth):
            left = forest.left[t][node]
            internal = left >= 0
            tests += internal.sum()
            f = forest.feature[t][node].long()
            seen[rows[internal], f[internal]] = True
            v = X[rows, f]
            goleft = torch.where(torch.isnan(v), forest.default_left[t][node],
                                 v < forest.cond[t][node])
            nxt = torch.where(goleft, left, forest.right[t][node]).long()
            node = torch.where(internal, nxt, node)
    return int(seen.sum()) * 4, int(tests)


def phase_walk_kernel():
    """Kernel B against its plain version on forests of T depth-6 trees,
    rows with 5% NaNs, at each of ``WALK_SHAPES``; returns the T = 10 entry
    with every shape under ``shapes``."""
    rng = np.random.RandomState(3)
    shapes = []
    for T, rows in WALK_SHAPES:
        forest = _random_forest(rng, T, DEPTH, COLS)
        Xe, _, _ = _make_data(rows, COLS, 0.05, seed=7)
        X = torch.as_tensor(Xe, device=DEVICE)
        base = torch.zeros((rows, 1), device=DEVICE)
        tw = torch.ones(T, device=DEVICE)
        m = min(rows, WALK_PLAIN_ROWS) if T > 10 else rows
        got = predict_margin(forest, X, base)
        want = _predict_margin_plain(forest, X[:m], base[:m], tw)
        torch.cuda.synchronize()
        err = float((got[:m] - want).abs().max())
        check(torch.allclose(got[:m], want, rtol=1e-5, atol=1e-5),
              f"walk kernel T={T} == plain (max abs err {err})")
        check(bool(torch.isfinite(got).all()), f"walk kernel T={T}: finite")
        run = lambda: predict_margin(forest, X, base)  # noqa: E731
        ms = time_ms(run)
        k_ms = kernel_ms(run, "B")
        plain_ms = time_ms(
            lambda: _predict_margin_plain(forest, X[:m], base[:m], tw),
            reps=5 if T > 10 else TIMING_REPS, warmup=1)
        N = forest.left.shape[1]
        nbytes = walk_need(forest, X)[0] + 2 * rows * 4 + T * N * 16 + T * 8
        bnd, by = bound_ms(nbytes, rows * T * DEPTH * 2)
        print(f"kernel B (T={T}, depth {DEPTH}, {rows} rows): {ms:.4f} ms "
              f"(alone {k_ms} ms)  plain {plain_ms:.4f} ms on {m} rows  "
              f"bound {bnd:.4f} ms ({by})  max abs err {err}")
        shapes.append(dict(T=T, rows=rows, ms=ms, kernel_ms=k_ms,
                           plain_ms=plain_ms, plain_rows=m, bound_ms=bnd,
                           bound_by=by, max_abs_err=err))
        del forest, X, base, got, want
    main = next(x for x in shapes if x["T"] == 10)
    return dict({k: v for k, v in main.items() if k not in ("T", "rows")},
                library_ms=None, shapes=shapes)


def phase_walk_past_2_31():
    """Kernel B on 43M x 50 rows, just over 2^31 elements of X (8.6 GB):
    the wrapper launches the kernel over row chunks of fewer than 2^31
    elements; rows at both sides of the chunk boundary, of the 2^31st
    element and at the end equal the plain walk's."""
    n = ELEMS_2_31 // COLS + 1
    forest = _random_forest(np.random.RandomState(5), 10, DEPTH, COLS)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(5)
    X = torch.randn((n, COLS), generator=gen, device=DEVICE)
    X.view(-1)[::19] = float("nan")
    base = torch.zeros((n, 1), device=DEVICE)
    tw = torch.ones(10, device=DEVICE)
    reset_launches()
    got = predict_margin(forest, X, base)
    launched = predict_margin.launches
    chunks = walk_row_chunks(n, COLS)
    check(launched == len(chunks) == 2,
          f"past 2^31: {launched} launches over {chunks}")
    err = 0.0
    at_2_31 = ELEMS_2_31 // COLS
    for lo in (0, chunks[0][1] - 3000, at_2_31 - 3000, n - 3000):
        rows = slice(lo, min(n, lo + 6000))
        want = _predict_margin_plain(forest, X[rows], base[rows], tw)
        err = max(err, float((got[rows] - want).abs().max()))
    check(err <= 1e-5, f"past 2^31: kernel == plain on the sampled rows "
                       f"(max abs err {err})")
    check(bool(torch.isfinite(got).all()), "past 2^31: finite")
    ms = time_ms(lambda: predict_margin(forest, X, base), reps=5, warmup=1)
    print(f"kernel B past 2^31 ({n} x {COLS} = {n * COLS} elements, "
          f"{launched} launches): {ms:.4f} ms, == plain at rows around the "
          f"chunk edge {chunks[0][1]} and element 2^31 (max abs err {err})")
    del X, base, got
    torch.cuda.empty_cache()
    return dict(rows=n, launches=launched, ms=ms, max_abs_err=err)


def _random_cat_forest(rng, T, depth):
    """T depth-6 heap trees over ``X`` from ``_make_cat_data``: about half
    the internal nodes split on a categorical column, each with a random
    right-going set of that column's categories."""
    forest = _random_forest(rng, T, depth, COLS)
    N = forest.left.shape[1]
    internal = forest.left.cpu().numpy() >= 0
    is_cat = internal & (rng.rand(T, N) < 0.5)
    cols = np.array([c for c, _ in CAT_COLUMNS])
    counts = dict(CAT_COLUMNS)
    feature = forest.feature.cpu().numpy()
    feature[is_cat] = cols[rng.randint(0, len(cols), int(is_cat.sum()))]
    W = -(-max(counts.values()) // 32)
    sets = np.zeros((T, N, W * 32), bool)
    for t, i in zip(*np.nonzero(is_cat)):
        sets[t, i, :counts[feature[t, i]]] = rng.rand(counts[feature[t, i]]) < .5
    bits = (sets.reshape(T, N, W, 32).astype(np.uint64)
            << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)
    return forest_from_numpy(
        forest.left.cpu().numpy(), forest.right.cpu().numpy(), feature,
        forest.cond.cpu().numpy(), forest.default_left.cpu().numpy(),
        np.zeros(T), depth, 1, device=DEVICE, heap_layout=True,
        split_type=is_cat, cat_bits=bits)


def phase_cat_walk():
    """The categorical walk (plain torch on every device; no kernel is owed
    for it) at T = 10 and 500 on 100k rows of the categorical data: the
    card's margins equal the CPU's on the first 10k rows within 1e-5, and
    kernel B is never launched."""
    rng = np.random.RandomState(9)
    Xc, _, _ = _make_cat_data(EVAL_ROWS, COLS, seed=8)
    X = torch.as_tensor(Xc, device=DEVICE)
    base = torch.zeros((EVAL_ROWS, 1), device=DEVICE)
    out = []
    for T in (10, 500):
        forest = _random_cat_forest(rng, T, DEPTH)
        check(forest.has_cats, f"categorical walk T={T}: has_cats")
        reset_launches()
        got = predict_margin(forest, X, base)
        check(predict_margin.launches == 0,
              f"categorical walk T={T}: kernel B launched")
        cpu = forest_from_numpy(
            forest.left.cpu().numpy(), forest.right.cpu().numpy(),
            forest.feature.cpu().numpy(), forest.cond.cpu().numpy(),
            forest.default_left.cpu().numpy(), np.zeros(T), DEPTH, 1,
            split_type=forest.split_type.cpu().numpy(),
            cat_bits=forest.cat_bits.cpu().numpy())
        m = 10_000
        want = predict_margin(cpu, X[:m].cpu(), base[:m].cpu())
        err = float((got[:m].cpu() - want).abs().max())
        check(err <= 1e-5, f"categorical walk T={T}: card == CPU ({err})")
        ms = time_ms(lambda: predict_margin(forest, X, base),
                     reps=5 if T > 10 else TIMING_REPS, warmup=1)
        print(f"categorical walk (plain torch, T={T}, depth {DEPTH}, "
              f"{EVAL_ROWS} rows): {ms:.4f} ms on the card; card == CPU on "
              f"{m} rows (max abs err {err})")
        out.append(dict(T=T, rows=EVAL_ROWS, ms=ms, max_abs_err=err))
        del forest, got
    return out


def phase_train(name, params, Xtr, ytr, Xte, yte, rounds, want,
                feature_types=None, min_auc=0.80, feature_weights=None):
    """train() with eval, predict() and inplace_predict() through the public
    entry points; the launch counts of the run must equal ``want`` (kernel
    B: at least ``want["B"]``)."""
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dtrain = xgbt.DMatrix(Xtr, ytr, feature_types=feature_types,
                          feature_weights=feature_weights)
    dtest = xgbt.DMatrix(Xte, yte, feature_types=feature_types)
    max_bin = params.get("max_bin", DEFAULT_MAX_BIN)
    binned = dtrain.get_binned(max_bin)
    torch.cuda.synchronize()
    t_ingest = time.perf_counter() - t0
    res = {}
    t0 = time.perf_counter()
    bst = xgbt.train(params, dtrain, rounds, evals=[(dtest, "test")],
                     evals_result=res, verbose_eval=True)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    onehot = binned.fused_onehot()
    fh = 0 if onehot is None else onehot.shape[0] // max_bin
    t0 = time.perf_counter()
    preds = bst.predict(xgbt.DMatrix(Xte))
    t_pred = time.perf_counter() - t0
    inplace = bst.inplace_predict(Xte)
    inplace_m = bst.inplace_predict(Xte, predict_type="margin")
    got = launches()
    auc = res["test"]["auc"]
    print(f"{name}: max_bin {max_bin} ({binned.bins.dtype}), hoisted "
          f"{fh}/{COLS} features; ingest {t_ingest:.3f} s, train {rounds} "
          f"rounds {t_train:.3f} s ({t_train / rounds * 1e3:.1f} ms/round "
          f"incl. eval), predict {t_pred:.3f} s; launches {got}; auc "
          f"{auc[0]:.6f} -> {auc[-1]:.6f}")
    check(binned.cuts.max_bin == max_bin, f"{name}: max_bin")
    for k, v in want.items():
        ok = got[k] >= v if k == "B" else got[k] == v
        check(ok, f"{name}: kernel {k} launched {got[k]} times, want {v}")
    check(auc[-1] >= min_auc and auc[-1] > auc[0],
          f"{name}: held-out AUC {auc}")
    check(preds.shape == (EVAL_ROWS,) and np.isfinite(preds).all(),
          f"{name}: predictions finite, one per row")
    cached = bst.predict(dtest)  # the eval set's incrementally cached margin
    check(np.allclose(preds, cached, rtol=1e-5, atol=1e-6),
          f"{name}: fresh predict == cached eval margins")
    check(np.array_equal(inplace, preds), f"{name}: inplace_predict == predict")
    check(np.array_equal(inplace_m, bst.predict(xgbt.DMatrix(Xte),
                                                output_margin=True)),
          f"{name}: inplace_predict margin == predict margin")
    metrics = dict(max_bin=max_bin, hoisted_features=fh, auc=auc,
                   logloss=res["test"]["logloss"], train_s=t_train,
                   ms_per_round=t_train / rounds * 1e3, ingest_s=t_ingest,
                   predict_s=t_pred, launches=got)
    return bst, metrics


def phase_construct_route(Xtr, ytr, hoisted_trees, params=PARAMS,
                          feature_types=None, name="construct route",
                          group=None):
    """The model with hoisting disabled: kernel A at every level of every
    tree (K trees per round for K output groups), and the trees of the
    hoisted run. Returns the launches, the Booster and its training
    matrix (query sizes ``group``, if given; its hoist plan stays 0)."""
    reset_launches()
    os.environ["XGBTPU_HOIST_BUDGET_MB"] = "0"
    try:
        dtrain = xgbt.DMatrix(Xtr, ytr, feature_types=feature_types,
                              group=group)
        bst = xgbt.train(params, dtrain, CPU_ROUNDS, verbose_eval=False)
        torch.cuda.synchronize()
    finally:
        del os.environ["XGBTPU_HOIST_BUDGET_MB"]
    got = launches()
    trees = CPU_ROUNDS * bst.n_groups
    print(f"{name} (XGBTPU_HOIST_BUDGET_MB=0): launches {got}")
    want = {"A": trees * DEPTH, "C": 0, "D": 0}
    for k, v in want.items():
        check(got[k] == v, f"{name}: kernel {k} launched {got[k]} times, "
                           f"want {v}")
    same_trees(heap_trees(bst, trees), hoisted_trees,
               f"{name} vs hoisted route")
    print(f"{name}: {trees} trees identical to the hoisted run's")
    return got, bst, dtrain


def _json_trees(bst):
    model = bst.save_json()["learner"]["gradient_booster"]["model"]
    trees = model.get("gbtree", model)["trees"]
    keys = ("left_children", "split_indices", "split_type", "categories",
            "categories_nodes", "categories_sizes", "default_left")
    return [{k: t[k] for k in keys} for t in trees]


def phase_card_vs_cpu(Xtr, ytr, Xte, feature_types=None,
                      name="card vs CPU", params=PARAMS_DEFAULT, group=None,
                      group_weights=None, hoist_budget_mb=None,
                      want_launches=None, rounds=CPU_ROUNDS, **info):
    """``rounds`` (3) rounds of ``params`` (max_bin 256 unless they set it)
    on the card and on the CPU: same trees (and category sets; K x
    ``num_parallel_tree`` per round for K output groups; DART's
    ``weight_drop``), same predictions.
    ``info`` holds per-row arrays for the DMatrix (the label bounds).
    With query sizes ``group`` the rows are taken whole (at most
    ``CPU_ROWS``); ``group_weights`` are then set after the first
    binning. ``hoist_budget_mb`` sets ``XGBTPU_HOIST_BUDGET_MB`` for the
    card's run (0: the construct route; a partial hoist below the full
    one-hot's size), and ``want_launches`` the card's kernel launches."""
    X, y = Xtr[:CPU_ROWS], ytr[:CPU_ROWS]
    info = {k: v[:CPU_ROWS] for k, v in info.items()}
    check(group is None or int(np.sum(group)) == len(X),
          f"{name}: whole queries")
    out = []
    t0 = time.perf_counter()
    reset_launches()
    for dev in (DEVICE, torch.device("cpu")):
        d = xgbt.DMatrix(X, y, feature_types=feature_types, group=group,
                         device=dev, **info)
        if hoist_budget_mb is not None and dev == DEVICE:
            os.environ["XGBTPU_HOIST_BUDGET_MB"] = str(hoist_budget_mb)
        try:
            if group_weights is not None:
                d.get_binned(DEFAULT_MAX_BIN)
                d.set_weight(group_weights)
            bst = xgbt.train(params, d, rounds, verbose_eval=False)
        finally:
            os.environ.pop("XGBTPU_HOIST_BUDGET_MB", None)
        out.append((heap_trees(bst, bst._gbm.model.num_trees),
                    bst.predict(xgbt.DMatrix(Xte[:10000], device=dev)),
                    _json_trees(bst), getattr(bst._gbm, "weight_drop", None)))
        if dev == DEVICE and hoist_budget_mb is not None:
            got = launches()
            onehot = d.get_binned(DEFAULT_MAX_BIN).fused_onehot()  # frozen
            fh = 0 if onehot is None else onehot.shape[0] // DEFAULT_MAX_BIN
            check(fh == 0 if hoist_budget_mb == 0 else 0 < fh < X.shape[1],
                  f"{name}: card hoisted {fh} features")
            for k, v in (want_launches or {}).items():
                check(got[k] == v, f"{name}: kernel {k} launched {got[k]} "
                                   f"times, want {v}")
    ((card_trees, card_pred, card_json, card_drop),
     (cpu_trees, cpu_pred, cpu_json, cpu_drop)) = out
    same_trees(card_trees, cpu_trees, name)
    check(card_json == cpu_json, f"{name}: model JSON trees")
    check(card_drop == cpu_drop, f"{name}: DART weight_drop")
    err = float(np.abs(card_pred - cpu_pred).max())
    check(err <= 1e-5, f"{name} predictions max abs err {err}")
    route = "" if hoist_budget_mb is None else (
        f", card hoisted {fh}/{X.shape[1]} features, launches {got}")
    print(f"{name} (max_bin {params.get('max_bin', DEFAULT_MAX_BIN)}"
          f"{route}): {len(card_trees)} "
          f"trees identical, predictions max abs err {err} "
          f"({time.perf_counter() - t0:.1f} s)")
    return err


def _cat_level_case(Xtr, ytr, types):
    """The categorical configuration's binned matrix, one-hot, quantised
    gradients and grower config at max_bin 256."""
    d = xgbt.DMatrix(Xtr, ytr, feature_types=types)
    binned = d.get_binned(DEFAULT_MAX_BIN)
    n, F = binned.bins.shape
    cfg, _ = _cat_cfg(GrowParams(max_depth=DEPTH, split=SplitParams()),
                      binned, TrainParam())
    check(set(cfg.categorical) == set(ONEHOT_COLUMNS)
          and len(cfg.cat_partition) == len(CAT_COLUMNS) - 2,
          f"categorical gate: one-hot {cfg.categorical}, partition "
          f"{cfg.cat_partition}")
    obj = create_objective("binary:logistic")
    grad, hess = obj.get_gradient(torch.zeros(n, device=DEVICE), d.label,
                                  None)
    return binned, hk.quantize_gradients(grad, hess), cfg


def phase_cat_levels(Xtr, ytr, types):
    """Kernels A and D at every level of a real categorical tree with its
    [Kp, 5+B] tables: routing launches alone and both kernels bitwise equal
    to their plain versions and to each other; each timed with the wide
    table and with its first 4 columns (the same positions and bins)."""
    B = DEFAULT_MAX_BIN
    binned, gq, cfg = _cat_level_case(Xtr, ytr, types)
    bins, bins_t, cuts = binned.bins, binned.feature_major(), binned.cut_values
    n, F = bins.shape
    onehot = binned.fused_onehot()
    check(onehot is not None, "categorical: the hoist plan hoists")
    Fh = onehot.shape[0] // B
    check(Fh <= min(c for c, k in CAT_COLUMNS if k == 200),
          f"categorical: the 200-category columns lie outside the hoisted "
          f"prefix of {Fh}")
    st = _init_state(cfg, gq.totals(), B)
    check(st.ptab.shape[1] == 5 + B, "categorical: table width 5+B")
    pos = torch.zeros((n, 1), dtype=torch.int32, device=DEVICE)
    levels = []
    for lvl in range(DEPTH):
        K, Kp = 1 << lvl, (1 << lvl) >> 1
        kw = dict(K=K, Kp=Kp, B=B, d=lvl)
        ptab = st.ptab
        tag = f"categorical level {lvl}"
        check(ptab.shape == (max(Kp, 1), 5 + B), f"{tag}: table {ptab.shape}")
        pa, ha = hk._fused_level_cuda(bins, pos, gq, ptab, bins_t=bins_t,
                                      **kw)
        pd, hd = hk._hoisted_level_cuda(bins, onehot, pos, gq, ptab, **kw)
        pap, hap = hk._fused_level_plain(bins, pos, gq, ptab, **kw)
        pra, loc = hk._level_records_cuda(bins, pos, gq, ptab, **kw)
        prd, rec, _ = hk._channel_records_cuda(bins, pos, gq, ptab, Fh=Fh,
                                               **kw)
        torch.cuda.synchronize()
        for what, p_ in (("A", pa), ("D", pd), ("A's routing launch", pra),
                         ("D's routing launch", prd)):
            check(torch.equal(p_, pap), f"{tag}: pos {what} == plain")
        check(torch.equal(ha, hap) and torch.equal(hd, hap),
              f"{tag}: int64 hist A == D == plain")
        check(torch.equal(loc, hk._level_records_plain(pap, K=K, d=lvl)),
              f"{tag}: A's records == plain")
        check(torch.equal(rec, hk._channel_records_plain(pap, gq, K=K,
                                                         d=lvl)),
              f"{tag}: D's records == plain")
        n_cat = int(ptab[:Kp, 4].sum()) if Kp else 0
        del pa, ha, pap, hap, pra, loc, prd, rec
        narrow = ptab[:, :4].contiguous()
        row = dict(level=lvl, categorical_nodes=n_cat)
        for key, table in (("wide", ptab), ("narrow", narrow)):
            a_run = lambda t=table: hk.fused_level(  # noqa: E731
                bins, pos, gq, t, bins_t=bins_t, **kw)
            d_run = lambda t=table: hk.fused_level(  # noqa: E731
                bins, pos, gq, t, onehot=onehot, **kw)
            row[key] = dict(
                A_ms=time_ms(a_run), A_kernel_ms=kernel_ms(a_run, "A"),
                A_route_ms=kernel_ms(a_run, "A_route"),
                D_ms=time_ms(d_run), D_kernel_ms=kernel_ms(d_run, "D"),
                D_route_ms=kernel_ms(d_run, "D_route"))
        levels.append(row)
        w, nw = row["wide"], row["narrow"]
        print(f"{tag} (K={K}, {n_cat} of {Kp} nodes categorical, table "
              f"{tuple(ptab.shape)}): A {w['A_ms']:.4f} ms (alone "
              f"{w['A_kernel_ms']}, routing {w['A_route_ms']}) | width 4 "
              f"{nw['A_ms']:.4f} ({nw['A_kernel_ms']}, {nw['A_route_ms']}); "
              f"D {w['D_ms']:.4f} ms (alone {w['D_kernel_ms']}, routing "
              f"{w['D_route_ms']}) | width 4 {nw['D_ms']:.4f} "
              f"({nw['D_kernel_ms']}, {nw['D_route_ms']}) | bitwise equal")
        lane = (torch.arange(2 * K, device=DEVICE) >= K).long()[None, :, None]
        st = _level_update(st, gq.dequantize(hd, lane), cuts, cfg, lvl)
        pos = pd
    check(any(x["categorical_nodes"] for x in levels),
          "categorical: some level routes through categorical nodes")
    del onehot, binned
    torch.cuda.empty_cache()

    def mean(route, table, key):
        vals = [x[table][f"{route}_{key}"] for x in levels]
        return None if None in vals else sum(vals) / len(vals)

    return {r: {t: {k: mean(r, t, k) for k in ("ms", "kernel_ms", "route_ms")}
                for t in ("wide", "narrow")} for r in "AD"}, levels


def phase_cat_path(Xtr, ytr, Xte, yte, types):
    """The categorical path through the entry points, hoisted: C once, D 60
    times, A and B never; one-hot and partition nodes; AUC above the
    all-numerical run's; the saved JSON predicts the same."""
    bst, metrics = phase_train(
        "categorical path", PARAMS_DEFAULT, Xtr, ytr, Xte, yte, ROUNDS,
        {"A": 0, "C": 1, "D": ROUNDS * DEPTH}, feature_types=types,
        min_auc=0.75)
    check(metrics["launches"]["B"] == 0,
          "categorical path: kernel B never launched")
    hoisted_trees = heap_trees(bst, CPU_ROUNDS)  # before they go to the host
    trees = bst._gbm.model.trees
    onehot_nodes = sum(int((t.categorical_nodes() & np.isin(
        t.split_indices, ONEHOT_COLUMNS)).sum()) for t in trees)
    part_nodes = sum(int((t.categorical_nodes() & ~np.isin(
        t.split_indices, ONEHOT_COLUMNS)).sum()) for t in trees)
    check(onehot_nodes > 0 and part_nodes > 0,
          f"categorical path: one-hot nodes {onehot_nodes}, partition "
          f"nodes {part_nodes}")
    with tempfile.TemporaryDirectory(dir=os.path.dirname(
            os.path.abspath(__file__))) as tmp:
        path = os.path.join(tmp, "model.json")
        bst.save_model(path)
        loaded = xgbt.Booster(model_file=path)
    preds = bst.predict(xgbt.DMatrix(Xte))
    err = float(np.abs(loaded.predict(xgbt.DMatrix(Xte)) - preds).max())
    check(err <= 1e-5, f"categorical path: saved JSON predicts within 1e-5 "
                       f"({err})")
    del bst, loaded
    torch.cuda.empty_cache()
    res = {}
    t0 = time.perf_counter()
    num = xgbt.train(PARAMS_DEFAULT, xgbt.DMatrix(Xtr, ytr), ROUNDS,
                     evals=[(xgbt.DMatrix(Xte, yte), "test")],
                     evals_result=res, verbose_eval=False)
    torch.cuda.synchronize()
    num_s = time.perf_counter() - t0
    del num
    torch.cuda.empty_cache()
    num_auc = res["test"]["auc"]
    check(metrics["auc"][-1] > num_auc[-1],
          f"categorical AUC {metrics['auc'][-1]} above all-numerical "
          f"{num_auc[-1]}")
    print(f"categorical path: {onehot_nodes} one-hot and {part_nodes} "
          f"partition nodes; saved JSON max abs err {err}; AUC "
          f"{metrics['auc'][-1]:.6f} vs {num_auc[-1]:.6f} with every column "
          f"numerical ({num_s / ROUNDS * 1e3:.1f} ms/round)")
    metrics.update(onehot_nodes=onehot_nodes, partition_nodes=part_nodes,
                   json_max_abs_err=err, numerical_auc=num_auc,
                   numerical_ms_per_round=num_s / ROUNDS * 1e3)
    return metrics, hoisted_trees


class _RoundProbe(xgbt.callback.TrainingCallback):
    """Per-round host time (``update`` + eval, ending in a device
    synchronize) and kernel B's launches during the first round."""

    def __init__(self):
        self.times, self.first_b = [], None
        self._t0 = self._b0 = None

    def before_iteration(self, model, epoch, evals_log):
        torch.cuda.synchronize()
        self._b0 = predict_margin.launches
        self._t0 = time.perf_counter()
        return False

    def after_iteration(self, model, epoch, evals_log):
        torch.cuda.synchronize()
        self.times.append((time.perf_counter() - self._t0) * 1e3)
        if self.first_b is None:
            self.first_b = predict_margin.launches - self._b0
        return False

    def median_ms(self):
        return statistics.median(self.times)


def _model_trees(bst):
    """The saved model's trees, without their ids."""
    return [{k: v for k, v in t.items() if k != "id"} for t in
            bst.save_json()["learner"]["gradient_booster"]["model"]["trees"]]


def _logistic_obj(margin, dtrain):
    y = dtrain.get_label()
    p = 1.0 / (1.0 + np.exp(-margin.astype(np.float64)))
    return p - y, p * (1.0 - p)


def _error_metric(margin, dmat):
    return "err", float(np.mean((margin > 0.0) != (dmat.get_label() > 0.5)))


def _auc(bst, X, y):
    m = bst.predict(xgbt.DMatrix(X), output_margin=True)
    return create_metric("auc").evaluate(
        torch.as_tensor(m, device=DEVICE), torch.as_tensor(y, device=DEVICE))


#: the learning-rate schedule of the train-surface phase: 0.3 falling
#: linearly to 0.05 over its 10 rounds
SCHEDULE = [0.3 - 0.25 * i / (ROUNDS - 1) for i in range(ROUNDS)]
SURFACE_ES_ROUNDS, SURFACE_CV_ROWS = 60, 200_000


def phase_train_surface(Xtr, ytr, Xte, yte):
    """The training surface through the entry points at 1M x 50, max_bin
    256, depth 6, AUC + logloss (every check raises on failure): early
    stopping on a held-out set with permuted labels, ``iteration_range``
    against slicing; a learning-rate schedule stored tree by tree;
    continuation from a Booster and from bytes against one straight run;
    a numpy objective and metric; pickle and copy; ``update_many``
    against per-round ``update``; ``cv`` on 200k rows; round times."""
    p = PARAMS_DEFAULT
    out = {}
    t_phase = time.perf_counter()
    reset_launches()
    dtrain = xgbt.DMatrix(Xtr, ytr)
    dvalid = xgbt.DMatrix(Xte, yte)
    dnoise = xgbt.DMatrix(Xte, np.random.RandomState(42).permutation(yte))
    fresh = xgbt.DMatrix(Xte)  # in no Booster's cache

    # early stopping: the last set (noise) stops improving early
    probe, res = _RoundProbe(), {}
    bst = xgbt.train(p, dtrain, SURFACE_ES_ROUNDS,
                     evals=[(dvalid, "valid"), (dnoise, "noise")],
                     early_stopping_rounds=5, evals_result=res,
                     verbose_eval=False, callbacks=[probe])
    rounds = bst.num_boosted_rounds()
    best = bst.best_iteration
    check(rounds < SURFACE_ES_ROUNDS, f"early stopping: {rounds} rounds")
    check(best is not None and bst.attr("best_score") is not None
          and rounds == best + 6, f"early stopping: best_iteration {best}, "
          f"best_score {bst.attr('best_score')}, {rounds} rounds")
    b0 = predict_margin.launches
    ranged = bst.predict(dvalid, iteration_range=(0, best + 1))
    check(predict_margin.launches > b0, "iteration_range walks kernel B")
    sliced = bst[: best + 1].predict(dvalid)
    check(np.array_equal(ranged, sliced),
          "predict(iteration_range) == bst[:best + 1].predict, bitwise")
    check(np.array_equal(bst.predict(dvalid, iteration_range=(1, rounds)),
                         bst[1:].predict(dvalid)),
          "predict(iteration_range=(1, rounds)) == bst[1:].predict, bitwise")
    for v in res["valid"]["auc"] + res["noise"]["logloss"]:
        check(v == float(f"{v:.6f}"), "history rounded to 6 decimals")
    out["early_stopping"] = dict(
        rounds=rounds, best_iteration=best, best_score=bst.best_score,
        valid_auc=res["valid"]["auc"], noise_logloss=res["noise"]["logloss"],
        median_round_ms=probe.median_ms())
    print(f"train surface: early stopping after {rounds} rounds, "
          f"best_iteration {best}, best_score {bst.attr('best_score')}; "
          f"valid AUC {res['valid']['auc'][-1]:.6f}; median round "
          f"{probe.median_ms():.2f} ms with 2 eval sets and callbacks; "
          f"iteration_range == slice, bitwise")

    # pickle and copy of that model
    want = bst.predict(fresh)
    for how, dup in (("pickle", pickle.loads(pickle.dumps(bst))),
                     ("copy", bst.copy())):
        check(dup.device == bst.device and np.array_equal(
            dup.predict(fresh), want), f"{how}: predictions bitwise")
        check(dup.attributes() == bst.attributes(), f"{how}: attributes")
    del bst, dup

    # a learning-rate schedule
    probe = _RoundProbe()
    bst = xgbt.train(p, dtrain, ROUNDS, evals=[(dvalid, "valid")],
                     verbose_eval=False, callbacks=[
                         xgbt.callback.LearningRateScheduler(SCHEDULE),
                         probe])
    for i, e in enumerate(bst._gbm.model._entries):
        keep = e.keep.cpu().numpy()
        parent_kept = np.concatenate([[True], keep[(np.arange(
            1, keep.shape[0]) - 1) // 2]])
        leaf = ~keep & parent_kept
        want_leaf = (np.float32(SCHEDULE[i])
                     * e.node_weight.cpu().numpy()[leaf])
        check(e.eta == SCHEDULE[i] and np.array_equal(
            e.leaf_value.cpu().numpy()[leaf], want_leaf),
            f"schedule: tree {i} grown and stored with eta {SCHEDULE[i]}")
    out["schedule"] = dict(etas=SCHEDULE, median_round_ms=probe.median_ms())
    print(f"train surface: schedule {SCHEDULE[0]:.3f} -> {SCHEDULE[-1]:.3f}"
          f" stored tree by tree; median round {probe.median_ms():.2f} ms "
          f"with 1 eval set and callbacks")
    del bst

    # continuation: 10 + 10 from a Booster and from bytes, against 20
    first = xgbt.train(p, dtrain, ROUNDS, verbose_eval=False)
    raw = first.save_raw()
    # the walk that fills a continued model's training cache: the loaded
    # forest over every training row
    loaded = xgbt.Booster(model_file=raw)._gbm.model.stacked()
    base = torch.zeros((ROWS, 1), device=DEVICE)
    walk_ms = time_ms(lambda: predict_margin(loaded, dtrain.data, base))
    walk_kms = kernel_ms(lambda: predict_margin(loaded, dtrain.data, base),
                         "B")
    del loaded, base
    straight = xgbt.train(p, dtrain, 2 * ROUNDS, verbose_eval=False)
    cont = {}
    for src_name, src_model in (("booster", first), ("bytes", raw)):
        probe = _RoundProbe()
        bst = xgbt.train(p, dtrain, ROUNDS, xgb_model=src_model,
                         verbose_eval=False, callbacks=[probe])
        check(bst.num_boosted_rounds() == 2 * ROUNDS,
              f"continuation from {src_name}: 20 rounds")
        check(probe.first_b >= 1, f"continuation from {src_name}: kernel B "
              f"launched {probe.first_b} times in the first round")
        cont[src_name] = (bst, probe)
    b_trees, s_trees = _model_trees(cont["booster"][0]), _model_trees(straight)
    check(b_trees == _model_trees(cont["bytes"][0]),
          "continuation from a Booster == from bytes")
    check(b_trees[:ROUNDS] == s_trees[:ROUNDS],
          "continuation: the first 10 trees == the straight run's, bitwise")
    equal_later = sum(a == b for a, b in zip(b_trees[ROUNDS:],
                                             s_trees[ROUNDS:]))
    margin_err = float(np.abs(
        cont["booster"][0].predict(fresh, output_margin=True)
        - straight.predict(fresh, output_margin=True)).max())
    out["continuation"] = dict(
        equal_later_trees=equal_later, later_trees=ROUNDS,
        max_abs_margin_diff=margin_err,
        first_round_b_launches=cont["booster"][1].first_b,
        cache_walk_ms=walk_ms, cache_walk_kernel_ms=walk_kms,
        cache_walk_trees=ROUNDS, cache_walk_rows=ROWS)
    print(f"train surface: continuation (10 + 10, from a Booster and from "
          f"bytes) against 20 straight: first 10 trees identical, "
          f"{equal_later}/{ROUNDS} later trees identical, held-out margins "
          f"max abs diff {margin_err}; kernel B launched "
          f"{cont['booster'][1].first_b}x in the first continued round; "
          f"the cache fill's walk ({ROUNDS} trees, {ROWS} rows) "
          f"{walk_ms:.4f} ms (kernel alone {walk_kms} ms)")
    del first, straight, cont, bst

    # a numpy objective and metric against the built-in objective
    res_b, res_f = {}, {}
    builtin = xgbt.train(p, dtrain, 5, evals=[(dvalid, "valid")],
                         evals_result=res_b, verbose_eval=False)
    probe = _RoundProbe()
    fobj = xgbt.train({"eta": 0.1, "base_score": 0.0,
                       "disable_default_eval_metric": True}, dtrain, 5,
                      evals=[(dvalid, "valid")], obj=_logistic_obj,
                      custom_metric=_error_metric, evals_result=res_f,
                      verbose_eval=False, callbacks=[probe])
    auc_b, auc_f = _auc(builtin, Xte, yte), _auc(fobj, Xte, yte)
    check(list(res_f["valid"]) == ["err"], "custom metric only")
    check(abs(auc_f - auc_b) <= 1e-3,
          f"custom objective AUC {auc_f} vs built-in {auc_b}")
    out["custom_objective"] = dict(auc=auc_f, builtin_auc=auc_b,
                                   err=res_f["valid"]["err"],
                                   median_round_ms=probe.median_ms())
    print(f"train surface: numpy logistic objective + metric, 5 rounds: "
          f"held-out AUC {auc_f:.6f} vs built-in {auc_b:.6f}; median fobj "
          f"round {probe.median_ms():.2f} ms (margin to host, numpy "
          f"gradients, back to the card, 1 eval set)")
    del builtin, fobj

    # update_many against per-round update, and bare round times
    per_round, bare = xgbt.Booster(p, cache=[dtrain]), []
    for i in range(ROUNDS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        per_round.update(dtrain, i)
        torch.cuda.synchronize()
        bare.append((time.perf_counter() - t0) * 1e3)
    many = xgbt.Booster(p, cache=[dtrain])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    many.update_many(dtrain, 0, ROUNDS, chunk=5)
    torch.cuda.synchronize()
    many_ms = (time.perf_counter() - t0) * 1e3 / ROUNDS
    same_trees(heap_trees(many, ROUNDS), heap_trees(per_round, ROUNDS),
               "update_many vs per-round update")
    out["update_many"] = dict(mean_round_ms=many_ms,
                              median_update_ms=statistics.median(bare))
    print(f"train surface: update_many(0, 10, chunk=5) == 10 x update, "
          f"bitwise; bare rounds: update_many {many_ms:.2f} ms/round "
          f"(mean), update median {statistics.median(bare):.2f} ms")
    del per_round, many

    # cv on 200k rows
    dcv = xgbt.DMatrix(Xtr[:SURFACE_CV_ROWS], ytr[:SURFACE_CV_ROWS])
    c0 = hk.build_onehot.launches
    cvres = xgbt.cv(p, dcv, 5, nfold=3, early_stopping_rounds=3,
                    as_pandas=False)
    want_keys = [f"{s}-{m}-{a}" for s in ("train", "test")
                 for m in ("auc", "logloss") for a in ("mean", "std")]
    check(list(cvres) == want_keys, f"cv keys {list(cvres)}")
    check(all(np.isfinite(v).all() for v in cvres.values()), "cv finite")
    check(hk.build_onehot.launches - c0 == 3, "cv: one one-hot per fold")
    out["cv"] = {k: v for k, v in cvres.items()}
    print(f"train surface: cv 3 folds x {len(cvres['test-auc-mean'])} "
          f"rounds on {SURFACE_CV_ROWS} rows: test AUC "
          f"{cvres['test-auc-mean'][-1]:.6f} +- "
          f"{cvres['test-auc-std'][-1]:.6f}")
    del dtrain, dvalid, dnoise, fresh, dcv
    torch.cuda.empty_cache()
    got = launches()
    out["launches"] = got
    out["phase_s"] = time.perf_counter() - t_phase
    for k in ("B", "C", "D"):
        check(got[k] > 0, f"train surface: kernel {k} launched {got[k]}")
    print(f"train surface: launches {got}; {out['phase_s']:.1f} s")
    return out


#: the grower-breadth configurations (max_bin 256, depth 6, eta 0.1):
#: (a) uniform row and column sampling at every level, (b) minimal-variance
#: row sampling with a weighted per-tree column sample, (c) monotone and
#: interaction constraints (built from the generator's weights in
#: ``breadth_params``)
BREADTH_A = {**PARAMS_DEFAULT, "subsample": 0.7, "colsample_bytree": 0.7,
             "colsample_bylevel": 0.7, "colsample_bynode": 0.7}
BREADTH_B = {**PARAMS_DEFAULT, "subsample": 0.5,
             "sampling_method": "gradient_based", "colsample_bytree": 0.5}
BREADTH_GROUPS = [list(range(0, 10)), list(range(10, 30)),
                  list(range(30, 50))]
MONO_GRID_ROWS, MONO_GRID_VALUES = 1000, 21


def breadth_params(w):
    """Config (c): monotone constraints on the 10 features of largest
    ``|w|`` (the sign of ``w``), interaction groups ``BREADTH_GROUPS``."""
    mono = np.zeros(COLS, np.int64)
    top = np.argsort(-np.abs(w))[:10]
    mono[top] = np.sign(w[top]).astype(np.int64)
    return {**PARAMS_DEFAULT, "monotone_constraints": tuple(mono.tolist()),
            "interaction_constraints": BREADTH_GROUPS}, mono


def _leaf_paths(tree):
    """The split features of every root-to-leaf path of a saved tree."""
    lc, rc = tree["left_children"], tree["right_children"]
    feat = tree["split_indices"]
    out, stack = [], [(0, frozenset())]
    while stack:
        i, used = stack.pop()
        if lc[i] == -1:
            out.append(used)
        else:
            stack += [(lc[i], used | {feat[i]}), (rc[i], used | {feat[i]})]
    return out


def _host_ms(fn, reps: int = 10):
    """Median host time of ``fn`` ending in a device synchronize."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_grower_breadth(Xtr, ytr, Xte, yte, w):
    """Row and column sampling and monotone and interaction constraints
    through the entry points at 1M x 50, max_bin 256, depth 6, eta 0.1, 10
    rounds each: (a) uniform sampling, (b) MVS with feature weights, (c)
    monotone + interaction constraints. Each run launches C once, D 60
    times and B at least 10 times; held-out AUC rises (>= 0.75 for (a) and
    (b)). MVS keeps ``subsample`` of the rows within 2%; (c)'s predictions
    are monotone along each constrained feature on a grid and its paths
    stay inside one interaction group. (a) by the construct route gives the
    hoisted trees; (a) and (c) on the card and on the CPU give the same
    trees. Round times with and without sampling alternate on one matrix;
    a row draw plus MVS is timed at 1M rows."""
    out = {}
    t_phase = time.perf_counter()
    params_c, mono = breadth_params(w)
    fw = (np.abs(w) + 0.1).astype(np.float32)
    want = {"A": 0, "B": ROUNDS, "C": 1, "D": ROUNDS * DEPTH}
    runs = (("breadth (a) uniform sampling", BREADTH_A, 0.75, None),
            ("breadth (b) MVS + feature weights", BREADTH_B, 0.75, fw),
            ("breadth (c) monotone + interaction", params_c, 0.5, None))
    hoisted_a = bst_c = None
    for name, params, min_auc, weights in runs:
        bst, metrics = phase_train(name, params, Xtr, ytr, Xte, yte, ROUNDS,
                                   want, min_auc=min_auc,
                                   feature_weights=weights)
        out[name.split()[1]] = metrics
        if params is BREADTH_A:
            hoisted_a = heap_trees(bst, CPU_ROUNDS)
        if params is params_c:
            bst_c = bst
        else:
            del bst
        torch.cuda.empty_cache()

    # (c): monotone along each constrained feature, paths in one group
    rows = Xte[:MONO_GRID_ROWS]
    grid = np.linspace(-3.0, 3.0, MONO_GRID_VALUES, dtype=np.float32)
    used = 0
    for f in np.flatnonzero(mono):
        Xg = np.repeat(rows, grid.size, axis=0)
        Xg[:, f] = np.tile(grid, rows.shape[0])
        m = bst_c.predict(xgbt.DMatrix(Xg), output_margin=True)
        steps = np.diff(m.reshape(rows.shape[0], grid.size), axis=1) * mono[f]
        check((steps >= 0).all(), f"breadth (c): monotone along feature {f}")
        used += bool((steps > 0).any())
    groups = [set(g) for g in BREADTH_GROUPS]
    trees = bst_c.save_json()["learner"]["gradient_booster"]["model"]["trees"]
    paths = [p for t in trees for p in _leaf_paths(t)]
    check(all(any(p <= g for g in groups) for p in paths),
          "breadth (c): every path inside one interaction group")
    out["monotone"] = dict(features=int((mono != 0).sum()), used=used,
                           grid=[MONO_GRID_ROWS, MONO_GRID_VALUES],
                           paths=len(paths))
    print(f"breadth (c): monotone on a {MONO_GRID_ROWS} x {MONO_GRID_VALUES} "
          f"grid along {int((mono != 0).sum())} features ({used} of them "
          f"used by the model); {len(paths)} paths each inside one group")
    del bst_c
    torch.cuda.empty_cache()

    # (a) by the construct route: kernel A, the hoisted run's trees
    out["construct_a"] = phase_construct_route(
        Xtr, ytr, hoisted_a, params=BREADTH_A,
        name="breadth (a) construct route")[0]
    torch.cuda.empty_cache()

    # (a) and (c): the card and the CPU grow the same trees
    phase_card_vs_cpu(Xtr, ytr, Xte, name="breadth (a) card vs CPU",
                      params=BREADTH_A)
    phase_card_vs_cpu(Xtr, ytr, Xte, name="breadth (c) card vs CPU",
                      params=params_c)

    # MVS: kept fraction and the time of a row draw plus MVS at 1M rows,
    # on the gradients of a 3-round model
    dtrain = xgbt.DMatrix(Xtr, ytr)
    bst = xgbt.train(PARAMS_DEFAULT, dtrain, CPU_ROUNDS, verbose_eval=False)
    margin = torch.as_tensor(bst.predict(dtrain, output_margin=True),
                             device=DEVICE)
    grad, hess = create_objective("binary:logistic").get_gradient(
        margin, dtrain.label, None)
    key = threefry.prng_key(11)
    sub = BREADTH_B["subsample"]
    _, h_s = mvs_sample(key, grad, hess, sub, 1.0)
    kept = float((h_s != 0).float().mean())
    check(abs(kept / sub - 1.0) <= 0.02,
          f"MVS kept {kept:.6f} of the rows at subsample {sub}")
    mvs_ms = _host_ms(lambda: mvs_sample(key, grad, hess, sub, 1.0))
    cfg_u = GrowParams(subsample=BREADTH_A["subsample"])
    uni_ms = _host_ms(lambda: apply_row_sampling(cfg_u, key, grad, hess))
    out["mvs"] = dict(rows=int(grad.shape[0]), kept_fraction=kept,
                      draw_mvs_ms=mvs_ms, uniform_draw_ms=uni_ms)
    print(f"MVS at {grad.shape[0]} rows: kept {kept:.6f} (subsample {sub}); "
          f"row draw + MVS {mvs_ms:.3f} ms, uniform row draw {uni_ms:.3f} ms "
          f"(host clock around a synchronize, median of 10)")
    del bst, margin, grad, hess, h_s

    # round times with and without sampling, alternating on one matrix
    sampled = xgbt.Booster(BREADTH_A, [dtrain])
    plain = xgbt.Booster(PARAMS_DEFAULT, [dtrain])
    times = {"sampled": [], "plain": []}
    for i in range(ROUNDS):
        for tag, b in (("sampled", sampled), ("plain", plain)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            b.update(dtrain, i)
            torch.cuda.synchronize()
            times[tag].append((time.perf_counter() - t0) * 1e3)
    # round 0 of each booster fills its prediction cache: the medians
    # skip it
    med = {k: statistics.median(v[1:]) for k, v in times.items()}
    out["round_ms"] = dict(median=med, all=times)
    print(f"breadth rounds (update only, alternating, median of rounds "
          f"1-{ROUNDS - 1}): sampled (a) {med['sampled']:.2f} ms, "
          f"unsampled {med['plain']:.2f} ms")
    del sampled, plain, dtrain
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"grower breadth: {out['phase_s']:.1f} s")
    return out


MC_CLASSES = 7
PARAMS_MC = {"objective": "multi:softprob", "num_class": MC_CLASSES,
             "eta": 0.1, "eval_metric": ["merror", "mlogloss", "auc"]}


def _multiclass_labels(X, seed: int = 42):
    """argmax(0.5 X W + Gumbel noise) over ``MC_CLASSES`` classes, ``W``
    [F, 7] and the noise drawn from ``RandomState(seed + 3)``; NaNs read as
    0 for the label only (Covertype's 7 classes, in shape)."""
    rng = np.random.RandomState(seed + 3)
    W = rng.randn(X.shape[1], MC_CLASSES).astype(np.float32)
    g = rng.gumbel(size=(X.shape[0], MC_CLASSES)).astype(np.float32)
    return np.argmax(np.nan_to_num(X) @ W * 0.5 + g, axis=1).astype(
        np.float32)


def _walk_g7(forest, X, m):
    """Kernel B on ``forest`` against its plain version on the first ``m``
    rows; ``(err, got)``."""
    base = torch.zeros((X.shape[0], forest.n_groups), device=DEVICE)
    tw = torch.ones(forest.num_trees, device=DEVICE)
    got = predict_margin(forest, X, base)
    want = _predict_margin_plain(forest, X[:m], base[:m], tw)
    torch.cuda.synchronize()
    return float((got[:m] - want).abs().max()), got


def phase_walk_groups(mc_forest, Xte):
    """Kernel B at G = 7: on the 7-class model's own 70-tree forest (its
    interleaved ``tree_info``) over the held-out rows, and on a random
    70-tree forest with the same groups over the walk phase's 100k rows (5%
    NaN), each against its plain version within 1e-5; the random forest
    timed at G = 7 and, as one group, at G = 1 (the multi-group branch's
    per-tree read-modify-write of ``out[r, g]`` against the register
    accumulator)."""
    T, m = ROUNDS * MC_CLASSES, WALK_PLAIN_ROWS
    err_model, _ = _walk_g7(mc_forest, torch.as_tensor(Xte, device=DEVICE),
                            m)
    check(err_model <= 1e-5, f"kernel B G=7 on the model's forest == plain "
                             f"(max abs err {err_model})")
    rng = np.random.RandomState(77)
    forest = _random_forest(rng, T, DEPTH, COLS, G=MC_CLASSES)
    one = forest._replace(tree_group=torch.zeros_like(forest.tree_group),
                          n_groups=1)
    Xe, _, _ = _make_data(EVAL_ROWS, COLS, 0.05, seed=7)
    X = torch.as_tensor(Xe, device=DEVICE)
    err, got = _walk_g7(forest, X, m)
    check(err <= 1e-5, f"kernel B G=7 random forest == plain ({err})")
    check(bool(torch.isfinite(got).all()), "kernel B G=7: finite")
    base7 = torch.zeros((EVAL_ROWS, MC_CLASSES), device=DEVICE)
    base1 = torch.zeros((EVAL_ROWS, 1), device=DEVICE)
    tw = torch.ones(T, device=DEVICE)
    run7 = lambda: predict_margin(forest, X, base7)  # noqa: E731
    run1 = lambda: predict_margin(one, X, base1)  # noqa: E731
    ms, ms1 = time_ms(run7), time_ms(run1)
    k_ms, k_ms1 = kernel_ms(run7, "B"), kernel_ms(run1, "B")
    plain_ms = time_ms(lambda: _predict_margin_plain(forest, X[:m],
                                                     base7[:m], tw),
                       reps=5, warmup=1)
    N = forest.left.shape[1]
    nbytes = (walk_need(forest, X)[0] + 2 * EVAL_ROWS * MC_CLASSES * 4
              + T * N * 16 + T * 8)
    bnd, by = bound_ms(nbytes, EVAL_ROWS * T * DEPTH * 2)
    print(f"kernel B G={MC_CLASSES} (T={T}, depth {DEPTH}, {EVAL_ROWS} "
          f"rows): {ms:.4f} ms (alone {k_ms} ms); the same trees as one "
          f"group {ms1:.4f} ms (alone {k_ms1} ms); plain {plain_ms:.4f} ms "
          f"on {m} rows; bound {bnd:.4f} ms ({by}); max abs err {err}, on "
          f"the 7-class model's forest {err_model}")
    del forest, one, X, got
    return dict(G=MC_CLASSES, T=T, rows=EVAL_ROWS, ms=ms, kernel_ms=k_ms,
                plain_ms=plain_ms, plain_rows=m, bound_ms=bnd, bound_by=by,
                max_abs_err=err, model_forest_max_abs_err=err_model,
                one_group_ms=ms1, one_group_kernel_ms=k_ms1)


def phase_multiclass(X):
    """``multi:softprob`` with 7 classes through the entry points at 1M x
    50 (held out: the last 100k rows), depth 6, eta 0.1, max_bin 256, 10
    rounds, ``merror``/``mlogloss``/``auc`` on the held-out rows: C once,
    D 10 x 7 x 6 = 420 times, A never, B at least 10 times (all at G = 7);
    held-out ``mlogloss`` falling from round 1, ``merror`` below 1 minus
    the largest class share; probabilities summing to 1 within 1e-5;
    ``multi:softmax`` on the same model the argmax of the probabilities;
    ``inplace_predict`` equal to ``predict``. Then 3 rounds by the
    construct route (A 126 times, the hoisted run's 21 trees), 3 rounds on
    64k rows on the card and on the CPU (the same trees), and kernel B at
    G = 7 (``phase_walk_groups``)."""
    t_phase = time.perf_counter()
    y = _multiclass_labels(X)
    Xtr, Xte, ytr, yte = X[:ROWS], X[ROWS:], y[:ROWS], y[ROWS:]
    K = MC_CLASSES
    reset_launches()
    dtrain, dtest = xgbt.DMatrix(Xtr, ytr), xgbt.DMatrix(Xte, yte)
    probe, res = _RoundProbe(), {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bst = xgbt.train(PARAMS_MC, dtrain, ROUNDS, evals=[(dtest, "test")],
                     evals_result=res, verbose_eval=True, callbacks=[probe])
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    got = launches()
    want = {"A": 0, "C": 1, "D": ROUNDS * K * DEPTH}
    for k, v in want.items():
        check(got[k] == v, f"multiclass: kernel {k} launched {got[k]} "
                           f"times, want {v}")
    check(got["B"] >= ROUNDS, f"multiclass: kernel B launched {got['B']}")
    hoisted = heap_trees(bst, CPU_ROUNDS * K)
    mc_forest = bst._gbm.model.stacked()
    check(mc_forest.n_groups == K and mc_forest.tree_group.tolist()
          == list(range(K)) * ROUNDS, "multiclass: interleaved tree_info")
    hist = res["test"]
    share = float(np.bincount(yte.astype(np.int64), minlength=K).max()
                  / yte.size)
    print(f"multiclass: {K} classes, launches {got}, {t_train:.3f} s for "
          f"{ROUNDS} rounds, median round {probe.median_ms():.1f} ms "
          f"(update + eval); mlogloss {hist['mlogloss'][0]:.6f} -> "
          f"{hist['mlogloss'][-1]:.6f}, merror {hist['merror'][0]:.6f} -> "
          f"{hist['merror'][-1]:.6f} (largest class share {share:.6f}), "
          f"auc {hist['auc'][0]:.6f} -> {hist['auc'][-1]:.6f}")
    check(hist["mlogloss"][-1] < hist["mlogloss"][0],
          f"multiclass: mlogloss {hist['mlogloss']}")
    check(hist["merror"][-1] < 1.0 - share,
          f"multiclass: merror {hist['merror'][-1]} vs share {share}")
    b0 = predict_margin.launches
    prob = bst.predict(xgbt.DMatrix(Xte))
    check(predict_margin.launches > b0, "multiclass: predict walks kernel B")
    check(prob.shape == (EVAL_ROWS, K) and np.isfinite(prob).all(),
          f"multiclass: probabilities {prob.shape}")
    row_err = float(np.abs(prob.sum(axis=1) - 1.0).max())
    check(row_err <= 1e-5, f"multiclass: rows sum to 1 ({row_err})")
    check(np.array_equal(bst.inplace_predict(Xte), prob),
          "multiclass: inplace_predict == predict")
    raw = json.loads(bst.save_raw())
    raw["learner"]["objective"]["name"] = "multi:softmax"
    soft = xgbt.Booster(model_file=json.dumps(raw).encode())
    cls = soft.predict(xgbt.DMatrix(Xte))
    check(cls.shape == (EVAL_ROWS,) and np.array_equal(
        cls, np.argmax(prob, axis=1).astype(np.float32)),
        "multi:softmax == argmax of the softprob predictions")
    out = dict(classes=K, launches=got, train_s=t_train,
               median_round_ms=probe.median_ms(), round_ms=probe.times,
               mlogloss=hist["mlogloss"], merror=hist["merror"],
               auc=hist["auc"], largest_class_share=share,
               row_sum_max_err=row_err)
    del bst, soft, dtrain, dtest
    torch.cuda.empty_cache()
    out["walk_g7"] = phase_walk_groups(mc_forest, Xte)
    out["walk_g7"]["launches"] = got["B"]
    del mc_forest
    out["construct"] = phase_construct_route(
        Xtr, ytr, hoisted, params=PARAMS_MC,
        name="multiclass construct route")[0]
    torch.cuda.empty_cache()
    phase_card_vs_cpu(Xtr, ytr, Xte, name="multiclass card vs CPU",
                      params=PARAMS_MC, rounds=CUT_CPU_ROUNDS)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"multiclass: {out['phase_s']:.1f} s")
    return out


def _family_labels(objective, z, ybin, seed: int = 42):
    """Labels that suit ``objective``, from the standardized generator
    score ``z`` (and the binary labels ``ybin``), drawn from
    ``RandomState(seed + 5)``: ``(label, label_lower, label_upper)``."""
    rng = np.random.RandomState(seed + 5)
    n = z.shape[0]
    bounds = (None, None)
    if objective == "reg:squaredlogerror":  # exp of a score, minus 1
        y = np.expm1(1.0 + 0.5 * z + 0.1 * rng.randn(n))
    elif objective == "reg:pseudohubererror":  # Student-t noise
        y = z + rng.standard_t(2.0, n)
    elif objective == "reg:logistic":  # soft labels
        y = 1.0 / (1.0 + np.exp(-(z + 0.5 * rng.randn(n))))
    elif objective in ("binary:logitraw", "binary:hinge"):
        y = ybin
    elif objective == "count:poisson":
        y = rng.poisson(np.exp(0.5 * z))
    elif objective == "reg:gamma":
        y = rng.gamma(2.0, np.exp(0.5 * z) / 2.0)
    elif objective == "reg:tweedie":  # compound Poisson-Gamma, mostly 0
        k = rng.poisson(0.3 * np.exp(0.5 * z))
        y = np.where(k > 0, rng.gamma(2.0 * np.maximum(k, 1), 1.0), 0.0)
    else:
        t = 10.0 * np.exp(0.5 * z + 0.5 * rng.randn(n))
        if objective == "survival:cox":  # negative: censored
            y = np.where(rng.rand(n) < 0.3, -t, t)
        else:  # survival:aft: 60% exact, 30% right-, 10% interval-censored
            u = rng.rand(n)
            lower = np.where((u >= 0.6) & (u < 0.9),
                             t * rng.uniform(0.5, 1.0, n),
                             np.where(u >= 0.9, 0.7 * t, t))
            upper = np.select([u < 0.6, u < 0.9], [t, np.inf], 1.5 * t)
            y, bounds = lower, (lower, upper)
    f32 = (lambda a: None if a is None else np.asarray(a, np.float32))
    return f32(y), f32(bounds[0]), f32(bounds[1])


FAMILY = ("reg:squaredlogerror", "reg:pseudohubererror", "reg:logistic",
          "binary:logitraw", "binary:hinge", "count:poisson", "reg:gamma",
          "reg:tweedie")
#: metrics beside each objective's default, where they apply: ``mae``
#: where the objective's minimiser is near the label's median; ``mape``
#: nowhere, since every label set here has labels near 0, whose
#: ``|y - p| / |y|`` rules its mean (at 1M x 50 ``mape`` rises over 10
#: rounds of ``reg:squaredlogerror`` while its ``rmsle`` falls)
FAMILY_EXTRA = {"reg:squaredlogerror": ["mae"],
                "reg:pseudohubererror": ["mae"], "count:poisson": ["mae"],
                "reg:gamma": ["mae"]}
FAMILY_CARD_VS_CPU = ("count:poisson", "reg:gamma", "reg:tweedie",
                      "reg:pseudohubererror")
SURVIVAL_METRICS = {"survival:aft": ["aft-nloglik",
                                     "interval-regression-accuracy"],
                    "survival:cox": ["cox-nloglik"]}


def _family_run(name, params, dtrain, dtest, first):
    """``train`` for 10 rounds with its metrics on ``dtest``; the launches
    (C once on the first run of the shared matrix, then 0; D 60; A 0; B at
    least 10) and every metric finite and better in round 10 than in round
    1."""
    reset_launches()
    res = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    xgbt.train(params, dtrain, ROUNDS, evals=[(dtest, "test")],
               evals_result=res, verbose_eval=False)
    torch.cuda.synchronize()
    t = time.perf_counter() - t0
    got = launches()
    want = {"A": 0, "C": 1 if first else 0, "D": ROUNDS * DEPTH}
    for k, v in want.items():
        check(got[k] == v, f"{name}: kernel {k} launched {got[k]} times, "
                           f"want {v}")
    check(got["B"] >= ROUNDS, f"{name}: kernel B launched {got['B']}")
    hist = res["test"]
    for metric, vals in hist.items():
        check(all(np.isfinite(vals)), f"{name}: {metric} finite {vals}")
        better = (vals[-1] > vals[0] if create_metric(metric).maximize
                  else vals[-1] < vals[0])
        check(better, f"{name}: {metric} {vals[0]} -> {vals[-1]}")
    print(f"{name}: {t / ROUNDS * 1e3:.1f} ms/round incl. eval, launches "
          f"{got}; " + ", ".join(f"{k} {v[0]:.6f} -> {v[-1]:.6f}"
                                  for k, v in hist.items()))
    return dict(launches=got, ms_per_round=t / ROUNDS * 1e3, **hist)


def phase_objectives(X, ybin, w):
    """The regression family and the survival objectives through the entry
    points at 1M x 50 (held out: the last 100k rows), depth 6, eta 0.1,
    max_bin 256, 10 rounds each, on one training matrix whose labels (and
    label bounds) change between runs: ``FAMILY`` with each default metric
    plus ``FAMILY_EXTRA``, ``survival:aft`` (normal; ``aft-nloglik`` and
    ``interval-regression-accuracy``) and ``survival:cox`` (censored rows
    negative; ``cox-nloglik`` on held-out rows sorted by time, the metric's
    contract). Then ``FAMILY_CARD_VS_CPU`` on 64k rows for 3 rounds on the
    card and on the CPU: the same trees."""
    t_phase = time.perf_counter()
    s = np.nan_to_num(X) @ w
    z = ((s - s.mean()) / s.std()).astype(np.float32)
    dtrain, dtest = xgbt.DMatrix(X[:ROWS]), xgbt.DMatrix(X[ROWS:])
    out, labels = {}, {}
    for i, obj in enumerate(FAMILY + tuple(SURVIVAL_METRICS)):
        y, lo, hi = _family_labels(obj, z, ybin)
        labels[obj] = (y, lo, hi)
        for d, sl in ((dtrain, slice(0, ROWS)), (dtest, slice(ROWS, None))):
            d.set_label(y[sl])
            d.set_float_info("label_lower_bound", None if lo is None
                             else lo[sl])
            d.set_float_info("label_upper_bound", None if hi is None
                             else hi[sl])
        ev = dtest
        if obj == "survival:cox":
            order = np.argsort(np.abs(y[ROWS:]), kind="stable")
            ev = xgbt.DMatrix(X[ROWS:][order], y[ROWS:][order])
        default = create_objective(obj, None).default_metric()
        metrics = SURVIVAL_METRICS.get(obj) or [default] + FAMILY_EXTRA.get(
            obj, [])
        params = {"objective": obj, "eta": 0.1, "eval_metric": metrics}
        if obj == "survival:aft":
            params["aft_loss_distribution"] = "normal"
        out[obj] = _family_run(obj, params, dtrain, ev, first=i == 0)
    del dtrain, dtest
    torch.cuda.empty_cache()
    for obj in FAMILY_CARD_VS_CPU:
        y, _, _ = labels[obj]
        phase_card_vs_cpu(X[:ROWS], y[:ROWS], X[ROWS:],
                          name=f"{obj} card vs CPU",
                          params={"objective": obj, "eta": 0.1})
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"objectives: {out['phase_s']:.1f} s")
    return out


# MSLR-WEB10K-shaped ranking (Microsoft Learning to Rank Datasets; Qin & Liu,
# "Introducing LETOR 4.0 Datasets", 2013): 136 features, relevance 0-4,
# about 120 documents per query; synthetic, from a seed
RANK_COLS = 136
RANK_ROWS, RANK_EVAL_ROWS = 1_000_000, 100_000
#: the XGBoost LTR demo's parameters (max_bin left at 256)
RANK_PARAMS = {"objective": "rank:ndcg", "max_depth": DEPTH, "eta": 0.1,
               "eval_metric": ["ndcg@10", "map@10"]}
#: cumulative shares of the grades 0-3 within each query, roughly
#: MSLR-WEB10K's skew: about half the documents irrelevant
MSLR_GRADES = (0.52, 0.84, 0.965, 0.99)
RANK_OBJECTIVES = ("rank:pairwise", "rank:ndcg", "rank:map")
ALL_PAIRS_ROWS, ALL_PAIRS_EVAL_ROWS, ALL_PAIRS_ROUNDS = 200_000, 50_000, 5


def _make_rank_data(rows: int, lo: int, hi: int, seed: int = 42):
    """``(X, y, sizes)``: whole queries of ``lo``-``hi`` documents, at
    least ``rows`` rows; ``RANK_COLS`` standard normal features plus a
    per-query offset of each feature, 5% NaN; each document's relevance
    0-4 from its within-query score (the generator's weights times the
    features without the offset, plus noise), thresholded at the
    ``MSLR_GRADES`` quantiles of its query."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(lo, hi + 1, rows // lo + 1)
    sizes = sizes[:np.searchsorted(np.cumsum(sizes), rows) + 1]
    n, G, F = int(sizes.sum()), len(sizes), RANK_COLS
    X = rng.standard_normal((n, F), dtype=np.float32)
    w = rng.standard_normal(F, dtype=np.float32)
    s = X @ w + 2.0 * rng.standard_normal(n, dtype=np.float32)
    X += np.repeat(rng.standard_normal((G, F), dtype=np.float32), sizes,
                   axis=0)
    X[rng.random((n, F), dtype=np.float32) < 0.05] = np.nan
    group_of = np.repeat(np.arange(G), sizes)
    local = np.empty(n)
    local[np.lexsort((s, group_of))] = (
        np.arange(n) - np.repeat(np.cumsum(sizes) - sizes, sizes))
    y = np.searchsorted(np.asarray(MSLR_GRADES),
                        local / np.repeat(sizes, sizes), side="right")
    return X, y.astype(np.float32), sizes


def _split_queries(X, y, sizes, rows: int):
    """The first whole queries holding about ``rows`` rows, and the rest."""
    q = int(np.searchsorted(np.cumsum(sizes), rows))
    cut = int(sizes[:q].sum())
    return (X[:cut], y[:cut], sizes[:q]), (X[cut:], y[cut:], sizes[q:])


def _round_kernel_ms(bst, dtrain, it: int, kernel: str):
    """One ``update`` under ``torch.profiler``: the device time of
    ``kernel``'s launches per level of the round's tree."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        bst.update(dtrain, it)
        torch.cuda.synchronize()
    return _profiled_ms(prof, kernel, DEPTH)


def _mean_level_bound(dtrain, which: int):
    """The mean over levels 0-5 of ``level_bounds`` for ``dtrain``'s bins
    at max_bin 256 with the hoist plan's prefix: ``which`` 0 for kernel D,
    1 for kernel A; ``(ms, bound_by of the last level)``."""
    bins = dtrain.get_binned(DEFAULT_MAX_BIN).bins
    n, F = bins.shape
    Fh = hk.hoist_plan(hk.onehot_rows(n), F, DEFAULT_MAX_BIN, DEVICE)
    per = [level_bounds(n, F, Fh, DEFAULT_MAX_BIN, bins.element_size(),
                        lvl)[which] for lvl in range(DEPTH)]
    return sum(b for b, _ in per) / DEPTH, per[-1][1]


def phase_rank_main(train, test):
    """``rank:ndcg`` on the MSLR-WEB10K-shaped configuration through the
    entry points: 10 rounds at 1M x 136 with ``ndcg@10``/``map@10`` on the
    held-out queries (the sampled-pair path: G * S^2 is far above the
    all-pairs budget); C once, D 60 times, A never, B at least 10 times;
    both metrics rising; ``inplace_predict`` equal to ``predict``; the
    saved JSON, loaded back, within 1e-5. Returns the Booster, its
    matrices, its first 3 trees and the phase's numbers."""
    from xgboost_tpu_torch.objective import ranking as trank

    (Xtr, ytr, str_), (Xte, yte, ste) = train, test
    reset_launches()
    dtrain = xgbt.DMatrix(Xtr, ytr, group=str_)
    dtest = xgbt.DMatrix(Xte, yte, group=ste)
    G, S = dtrain.groups.n_groups, dtrain.groups.max_size
    check(G * S * S > trank._ALL_PAIRS_BUDGET, "ranking: the sampled path")
    probe, res = _RoundProbe(), {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bst = xgbt.train(RANK_PARAMS, dtrain, ROUNDS, evals=[(dtest, "test")],
                     evals_result=res, verbose_eval=True, callbacks=[probe])
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    got = launches()
    want = {"A": 0, "C": 1, "D": ROUNDS * DEPTH}
    for k, v in want.items():
        check(got[k] == v, f"ranking: kernel {k} launched {got[k]} times, "
                           f"want {v}")
    check(got["B"] >= ROUNDS, f"ranking: kernel B launched {got['B']}")
    onehot = dtrain.get_binned(DEFAULT_MAX_BIN).fused_onehot()
    fh = 0 if onehot is None else onehot.shape[0] // DEFAULT_MAX_BIN
    check(0 < fh < RANK_COLS, f"ranking: a partial hoist ({fh} features)")
    hoisted = heap_trees(bst, CPU_ROUNDS)
    hist = res["test"]
    for name in RANK_PARAMS["eval_metric"]:
        check(hist[name][-1] > hist[name][0], f"ranking: {name} {hist[name]}")
    preds = bst.predict(xgbt.DMatrix(Xte))
    check(preds.shape == (Xte.shape[0],) and np.isfinite(preds).all(),
          "ranking: predictions finite, one per row")
    check(np.array_equal(bst.inplace_predict(Xte), preds),
          "ranking: inplace_predict == predict")
    back = xgbt.Booster(model_file=bst.save_raw())
    err = float(np.abs(back.predict(xgbt.DMatrix(Xte)) - preds).max())
    check(err <= 1e-5, f"ranking: saved JSON predicts within 1e-5 ({err})")
    margin = bst._predict_margin(dtrain)[:, 0]
    grad_ms = time_ms(lambda: bst._obj.get_gradient(
        margin, dtrain.label, None, ROUNDS, groups=dtrain.groups), reps=10)
    print(f"ranking (rank:ndcg, {Xtr.shape[0]} x {RANK_COLS} in {G} queries "
          f"of up to {S}, hoisted {fh}/{RANK_COLS} features): launches "
          f"{got}, {t_train:.3f} s for {ROUNDS} rounds, median round "
          f"{probe.median_ms():.1f} ms (update + eval), gradient "
          f"{grad_ms:.3f} ms; " + ", ".join(
              f"{k} {v[0]:.6f} -> {v[-1]:.6f}" for k, v in hist.items()))
    out = dict(rows=int(Xtr.shape[0]), queries=G, max_query=S,
               hoisted_features=fh, launches=got, train_s=t_train,
               median_round_ms=probe.median_ms(), round_ms=probe.times,
               gradient_ms=grad_ms, saved_json_max_abs_err=err, **hist)
    return bst, dtrain, dtest, hoisted, out


def phase_rank_inspect(bst, dtrain, dtest):
    """The inspection surface on the ranking model, on the card against the
    same model loaded on the CPU: ``get_score`` of all five types,
    ``get_dump`` text/json/dot with stats and a split-value histogram. Then
    a fresh Booster on the card given the model and ``load_config`` of the
    configuration trains the next round as the original does (the
    original's round profiled: kernel D's device time per level at F =
    136)."""
    cpu = xgbt.Booster(model_file=bst.save_raw(), device="cpu")
    for t in ("weight", "gain", "cover", "total_gain", "total_cover"):
        check(bst.get_score(importance_type=t)
              == cpu.get_score(importance_type=t), f"get_score {t}")
    for fmt in ("text", "json", "dot"):
        check(bst.get_dump(with_stats=True, dump_format=fmt)
              == cpu.get_dump(with_stats=True, dump_format=fmt),
              f"get_dump {fmt}")
    top = max(bst.get_score(), key=bst.get_score().get)
    h_card = bst.get_split_value_histogram(top, as_pandas=False)
    check(np.array_equal(h_card, cpu.get_split_value_histogram(
        top, as_pandas=False)), "get_split_value_histogram")
    fresh = xgbt.Booster()
    fresh.load_model(bst.save_raw())
    fresh.load_config(bst.save_config())
    # both take the next round's margins from the forest walk: the
    # original's cache, summed leaf by leaf onto the base margin of 0.5,
    # rounds differently from a walk
    bst._caches.clear()
    d_ms = _round_kernel_ms(bst, dtrain, ROUNDS, "D")
    d_bound = _mean_level_bound(dtrain, 0)
    fresh.update(dtrain, ROUNDS)
    check(fresh.save_raw() == bst.save_raw(),
          "load_config: the next round equals the original's")
    check(fresh.eval(dtest) == bst.eval(dtest), "load_config: eval")
    print(f"ranking inspection: get_score x5, get_dump x3, split histogram "
          f"of {top} ({len(h_card)} bins) card == CPU; save_config -> "
          f"load_config trains round {ROUNDS + 1} identically; kernel D "
          f"{d_ms} ms/level at F = {RANK_COLS} (profiled round; bound "
          f"{d_bound[0]:.4f} ms, {d_bound[1]})")
    return dict(kernel_D_ms_per_level=d_ms, kernel_D_bound_ms=d_bound[0],
                kernel_D_bound_by=d_bound[1], split_histogram_feature=top)


def phase_rank_levels(dtrain):
    """Kernels C, D and A against their plain versions at every level of a
    ranking tree at 1M x 136, max_bin 256 (``phase_level_kernels`` on the
    training matrix's bins and ``rank:ndcg``'s round-0 gradients): the
    hoist plan's partial prefix, so D's routing launch writes the other
    features feature-major and D reads both halves, and A at F = 136."""
    c, a, d = phase_level_kernels(dtrain, DEFAULT_MAX_BIN,
                                  RANK_PARAMS["objective"],
                                  prefix="ranking ")
    check(0 < d["Fh"] < RANK_COLS, f"ranking levels: a partial hoist "
                                   f"({d['Fh']} features)")
    return dict(C=c, A=a, D=d)


def phase_rank_construct(train, hoisted_trees):
    """The construct route on the ranking configuration
    (``phase_construct_route``: 3 rounds, kernel A 18 times, C and D
    never, the hoisted run's trees); a profiled fourth round gives kernel
    A's device time per level at F = 136."""
    Xtr, ytr, sizes = train
    got, bst, dtrain = phase_construct_route(
        Xtr, ytr, hoisted_trees, params=RANK_PARAMS,
        name="ranking construct route", group=sizes)
    a_ms = _round_kernel_ms(bst, dtrain, CPU_ROUNDS, "A")  # plan frozen: 0
    a_bound = _mean_level_bound(dtrain, 1)
    print(f"ranking construct route: kernel A {a_ms} ms/level at F = "
          f"{RANK_COLS} (profiled round; bound {a_bound[0]:.4f} ms, "
          f"{a_bound[1]})")
    return dict(launches=got, kernel_A_ms_per_level=a_ms,
                kernel_A_bound_ms=a_bound[0], kernel_A_bound_by=a_bound[1])


def phase_rank_all_pairs():
    """The all-pairs path at full width: 200k rows in queries of 8-32
    documents (G * S^2 about 1e7) and 50k held out; ``rank:pairwise``,
    ``rank:ndcg`` and ``rank:map`` for 5 rounds each with their default
    metric, the grouped ``auc``, ``pre@5`` and ``ndcg-`` on the training
    and the held-out queries: every default metric on the training queries
    higher in the last round than in the first. Returns the training data
    (for the card-against-CPU cut) and the phase's numbers."""
    from xgboost_tpu_torch.objective import ranking as trank

    X, y, sizes = _make_rank_data(ALL_PAIRS_ROWS + ALL_PAIRS_EVAL_ROWS, 8,
                                  32, seed=43)
    (Xtr, ytr, str_), (Xte, yte, ste) = _split_queries(X, y, sizes,
                                                       ALL_PAIRS_ROWS)
    dtrain = xgbt.DMatrix(Xtr, ytr, group=str_)
    dtest = xgbt.DMatrix(Xte, yte, group=ste)
    G, S = dtrain.groups.n_groups, dtrain.groups.max_size
    check(G * S * S <= trank._ALL_PAIRS_BUDGET, "all pairs: the padded path")
    out = {}
    for obj in RANK_OBJECTIVES:
        default = create_objective(obj, None).default_metric()
        res = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bst = xgbt.train({"objective": obj, "eta": 0.1,
                          "eval_metric": [default, "auc", "pre@5", "ndcg-"]},
                         dtrain, ALL_PAIRS_ROUNDS,
                         evals=[(dtrain, "train"), (dtest, "test")],
                         evals_result=res, verbose_eval=False)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / ALL_PAIRS_ROUNDS * 1e3
        margin = bst._predict_margin(dtrain)[:, 0]
        grad_ms = time_ms(lambda: bst._obj.get_gradient(
            margin, dtrain.label, None, ALL_PAIRS_ROUNDS,
            groups=dtrain.groups), reps=5)
        fit = res["train"][default]
        check(fit[-1] > fit[0], f"{obj}: training {default} {fit}")
        print(f"all pairs {obj} ({Xtr.shape[0]} rows in {G} queries of up "
              f"to {S}; G*S^2 {G * S * S}): {ms:.1f} ms/round incl. 2 "
              f"evals, gradient {grad_ms:.3f} ms; train {default} "
              f"{fit[0]:.6f} -> {fit[-1]:.6f}; held out "
              + ", ".join(f"{k} {v[0]:.6f} -> {v[-1]:.6f}"
                          for k, v in res["test"].items()))
        out[obj] = dict(ms_per_round=ms, gradient_ms=grad_ms,
                        train=res["train"], test=res["test"])
    return (Xtr, ytr, str_), out


def phase_rank_card_vs_cpu(all_pairs_train):
    """The ranking gradients on the card and the CPU grow the same trees:
    ``CUT_CPU_ROUNDS`` (2) rounds on cuts of whole queries at 136 features, ``rank:ndcg`` (on a
    partial hoist) and ``rank:map`` (on the construct route) on 64k rows
    in queries of 400-1000 documents (the sampled path) and all three
    objectives (full hoist) on the first 64k rows of the all-pairs data
    with per-group weights set after the first binning."""
    from xgboost_tpu_torch.objective import ranking as trank

    t0 = time.perf_counter()
    sampled, _ = _split_queries(*_make_rank_data(2 * CPU_ROWS, 400, 1000,
                                                 seed=44), CPU_ROWS)
    G, S = len(sampled[2]), int(sampled[2].max())
    check(G * S * S > trank._ALL_PAIRS_BUDGET, "the cut takes sampled pairs")
    cut, _ = _split_queries(*all_pairs_train, CPU_ROWS)
    w = np.random.default_rng(45).uniform(0.5, 2.0, len(cut[2])).astype(
        np.float32)
    errs = {}
    # the sampled cut on the card's two other level routes: rank:ndcg on a
    # partial hoist of about 33 of the 136 features (kernel D builds the
    # rest each level, as at 1M rows), rank:map on the construct route
    n_pad = hk.onehot_rows(len(sampled[1]))
    part_mb = 33 * DEFAULT_MAX_BIN * n_pad // (1 << 20) + 1
    levels = CUT_CPU_ROUNDS * DEPTH
    routes = {"rank:ndcg": (part_mb, {"A": 0, "C": 1, "D": levels}),
              "rank:map": (0, {"A": levels, "C": 0, "D": 0})}
    for obj, (mb, want) in routes.items():
        X, y, sizes = sampled
        errs[f"{obj} sampled"] = phase_card_vs_cpu(
            X, y, X, name=f"{obj} sampled card vs CPU", group=sizes,
            params={"objective": obj, "eta": 0.1}, hoist_budget_mb=mb,
            want_launches=want, rounds=CUT_CPU_ROUNDS)
    for obj in RANK_OBJECTIVES:
        X, y, sizes = cut
        errs[f"{obj} all pairs"] = phase_card_vs_cpu(
            X, y, X, name=f"{obj} all pairs card vs CPU", group=sizes,
            params={"objective": obj, "eta": 0.1}, group_weights=w,
            rounds=CUT_CPU_ROUNDS)
    t = time.perf_counter() - t0
    print(f"ranking card vs CPU: {len(errs)} runs of {CUT_CPU_ROUNDS} rounds, "
          f"trees identical, predictions max abs err "
          f"{max(errs.values())} ({t:.1f} s)")
    return dict(max_abs_err=errs, phase_s=t)


def phase_ranking():
    """Phases 18-23: the MSLR-WEB10K-shaped ranking configuration."""
    t_phase = time.perf_counter()
    X, y, sizes = _make_rank_data(RANK_ROWS + RANK_EVAL_ROWS, 60, 180)
    train, test = _split_queries(X, y, sizes, RANK_ROWS)
    del X, y
    bst, dtrain, dtest, hoisted, main = phase_rank_main(train, test)
    main["inspection"] = phase_rank_inspect(bst, dtrain, dtest)
    del bst, dtest
    torch.cuda.empty_cache()
    main["level_kernels"] = phase_rank_levels(dtrain)
    del dtrain
    torch.cuda.empty_cache()
    main["construct"] = phase_rank_construct(train, hoisted)
    del train, test
    torch.cuda.empty_cache()
    all_pairs_train, main["all_pairs"] = phase_rank_all_pairs()
    torch.cuda.empty_cache()
    main["card_vs_cpu"] = phase_rank_card_vs_cpu(all_pairs_train)
    main["phase_s"] = time.perf_counter() - t_phase
    print(f"ranking: {main['phase_s']:.1f} s")
    return main


# LightGBM's published Experiments comparison (docs/Experiments.rst, against
# xgboost_hist): best-first growth to num_leaves 255 with no depth limit
LG_LEAVES = 255
LG_PARAMS = {"objective": "binary:logistic", "grow_policy": "lossguide",
             "max_leaves": LG_LEAVES, "max_depth": 0, "eta": 0.1, **METRICS}
LG_STEPS = lossguide_steps(LG_LEAVES)
# XGBoost's DART tutorial (doc/tutorials/dart.rst)
DART_PARAMS = {"objective": "binary:logistic", "booster": "dart",
               "max_depth": 5, "learning_rate": 0.1, "sample_type": "uniform",
               "normalize_type": "tree", "rate_drop": 0.1, "skip_drop": 0.5,
               **METRICS}
DART_ROUNDS, DART_DEPTH = 50, 5
# XGBoost's random-forest tutorial (doc/tutorials/rf.rst)
RF_TREES, RF_DEPTH = 100, 5
RF_PARAMS = {"objective": "binary:logistic", "num_parallel_tree": RF_TREES,
             "max_depth": RF_DEPTH, "learning_rate": 1, "subsample": 0.8,
             "colsample_bynode": 0.8, **METRICS}
# the keys that change nothing (the JAX package warns and trains)
INERT_KEYS = {"sketch_eps": 0.1, "sparse_threshold": 0.5,
              "predictor": "gpu_predictor"}


def _capture_step(binned, grad, hess, max_leaves: int, step: int):
    """``(child slots, quantised gradients, K)`` that expansion step
    ``step`` of a real lossguide tree on ``binned`` gives kernel A (its
    ``fused_level_int`` call; call 0 is the root's)."""
    seen = []
    real = glg.fused_level_int

    def record(bins, pos, gq, ptab, **kw):
        if len(seen) == step:
            seen.append((pos.clone(), gq, kw["K"]))
        else:
            seen.append(None)
        return real(bins, pos, gq, ptab, **kw)

    glg.fused_level_int = record
    try:
        glg.grow_tree_lossguide(binned.bins, grad, hess, binned.cut_values,
                                GrowParams(max_depth=0, split=SplitParams()),
                                max_leaves, bins_t=binned.feature_major())
    finally:
        glg.fused_level_int = real
    return seen[step]


def phase_child_histograms(binned, grad, hess, max_leaves: int):
    """Kernel A on one step's child histograms (two thirds into the tree's
    steps) of a real tree at 1M x 50
    (``d = 0``, ``Kp = 0``, ``K = 2 K_EXP``): bitwise equal to its plain
    version, twice; timed beside the plain version, one ``index_add_`` of
    the same cells and its bound (the rows at a child read their bins, q
    and position; every row's position is read and written; the int64
    histogram written once)."""
    bins, B = binned.bins, binned.cuts.max_bin
    bins_t = binned.feature_major()
    n, F = bins.shape
    step = lossguide_steps(max_leaves) * 2 // 3
    seg, gq, K = _capture_step(binned, grad, hess, max_leaves, step)
    table = torch.zeros((1, 4), dtype=torch.float32, device=DEVICE)
    kw = dict(K=K, Kp=0, B=B, d=0)
    pk, hk_ = hk._fused_level_cuda(bins, seg, gq, table, bins_t=bins_t, **kw)
    pk2, hk2 = hk._fused_level_cuda(bins, seg, gq, table, bins_t=bins_t, **kw)
    pp, hp = hk._fused_level_plain(bins, seg, gq, table, **kw)
    torch.cuda.synchronize()
    tag = (f"lossguide child histograms (K={K}, step {step} of a "
           f"{max_leaves}-leaf tree)")
    check(torch.equal(pk, pp) and torch.equal(hk_, hp),
          f"{tag}: kernel A == plain")
    check(torch.equal(pk2, pk) and torch.equal(hk2, hk_), f"{tag}: twice")
    del pk, pk2, hk2, pp, hp
    def run():
        return hk.fused_level(bins, seg, gq, table, bins_t=bins_t, **kw)

    ms = time_ms(run)
    k_ms = kernel_ms(run, "A")
    lane = (torch.arange(2 * K, device=DEVICE) >= K).long()[None, :, None]
    plain_ms = time_ms(lambda: gq.dequantize(hk._fused_level_plain(
        bins, seg, gq, table, **kw)[1], lane), reps=5, warmup=1)
    lib_ms = _index_add_ms(bins, seg[:, 0].long(), grad, hess, K, B)
    active = int((seg >= 0).sum())
    nbytes = (active * (F * bins.element_size() + 8) + n * 8
              + F * 2 * K * B * 8)
    bnd, by = bound_ms(nbytes, 2 * active * F)
    print(f"{tag}: {active} of {n} rows at a child; kernel A {ms:.4f} ms "
          f"(alone {k_ms} ms)  plain {plain_ms:.4f} ms  index_add_ "
          f"{lib_ms:.4f} ms  bound {bnd:.4f} ms ({by}) | bitwise equal")
    return dict(K=K, step=step, rows_at_children=active, ms=ms,
                kernel_ms=k_ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bnd, bound_by=by, max_abs_err=0.0)


def phase_lossguide_walk(forest, Xte):
    """Kernel B on the lossguide forest (allocation order, explicit
    children; its walk bound the deepest node + 1) over the held-out rows:
    against its plain version on the first 10k rows, timed, with a bound
    that counts the node tests this data needs."""
    X = torch.as_tensor(Xte, device=DEVICE)
    base = torch.zeros((X.shape[0], 1), device=DEVICE)
    tw = torch.ones(forest.num_trees, device=DEVICE)
    m = WALK_PLAIN_ROWS
    got = predict_margin(forest, X, base)
    want = _predict_margin_plain(forest, X[:m], base[:m], tw)
    torch.cuda.synchronize()
    err = float((got[:m] - want).abs().max())
    check(torch.allclose(got[:m], want, rtol=1e-5, atol=1e-5),
          f"lossguide walk == plain (max abs err {err})")
    run = lambda: predict_margin(forest, X, base)  # noqa: E731
    ms = time_ms(run)
    k_ms = kernel_ms(run, "B")
    plain_ms = time_ms(lambda: _predict_margin_plain(forest, X[:m], base[:m],
                                                     tw), reps=5, warmup=1)
    x_bytes, tests = walk_need(forest, X)
    T, N = forest.left.shape
    nbytes = x_bytes + 2 * X.shape[0] * 4 + T * N * 16 + T * 8
    bnd, by = bound_ms(nbytes, 2 * tests)
    print(f"kernel B on the lossguide forest (T={T}, N={N}, walk bound "
          f"{forest.max_depth}, {X.shape[0]} rows, "
          f"{tests / X.shape[0] / T:.1f} tests per row and tree): {ms:.4f} ms (alone {k_ms} ms)  plain "
          f"{plain_ms:.4f} ms on {m} rows  bound {bnd:.4f} ms ({by})  max "
          f"abs err {err}")
    return dict(T=T, walk_bound=forest.max_depth, ms=ms, kernel_ms=k_ms,
                plain_ms=plain_ms, plain_rows=m, bound_ms=bnd, bound_by=by,
                max_abs_err=err, library_ms=None,
                tests_per_row_tree=tests / X.shape[0] / T)


def _leaf_counts(bst):
    model = bst.save_json()["learner"]["gradient_booster"]["model"]
    return [(len(t["left_children"]) + 1) // 2
            for t in model.get("gbtree", model)["trees"]]


def phase_lossguide(Xtr, ytr, Xte, yte, w):
    """Best-first growth at LightGBM's published settings (255 leaves, no
    depth limit, eta 0.1, max_bin 256) for 10 rounds through ``train``:
    kernel A 36 times a tree (the root and 35 steps of the top-8 queue), B
    once a round (the eval walk), C and D never; held-out AUC rising; at
    most 255 leaves a tree and 255 in at least one; ``inplace_predict``
    equal to ``predict``; the saved JSON, loaded back, within 1e-5. Then
    kernel A on real steps' child histograms at K = 16 and (a 31-leaf
    tree) K = 2, kernel B on the forest, and the card against the CPU at
    31 and 255 leaves with sampling and a monotone constraint."""
    t_phase = time.perf_counter()
    dtrain = xgbt.DMatrix(Xtr, ytr)
    dtest = xgbt.DMatrix(Xte, yte)
    binned = dtrain.get_binned(DEFAULT_MAX_BIN)
    binned.feature_major()
    torch.cuda.synchronize()
    probe = _RoundProbe()
    res = {}
    reset_launches()
    bst = xgbt.train(LG_PARAMS, dtrain, ROUNDS, evals=[(dtest, "test")],
                     evals_result=res, verbose_eval=False, callbacks=[probe])
    torch.cuda.synchronize()
    got = launches()
    want = {"A": ROUNDS * (1 + LG_STEPS), "B": ROUNDS, "C": 0, "D": 0}
    for k, v in want.items():
        check(got[k] == v, f"lossguide: kernel {k} launched {got[k]} times, "
                           f"want {v}")
    auc = res["test"]["auc"]
    check(auc[-1] > auc[0], f"lossguide: held-out AUC {auc}")
    forest = bst._gbm.model.stacked()  # the device-stacked forest
    walk = phase_lossguide_walk(forest, Xte)
    del forest
    preds = bst.predict(xgbt.DMatrix(Xte))
    check(np.array_equal(bst.inplace_predict(Xte), preds),
          "lossguide: inplace_predict == predict")
    leaves = _leaf_counts(bst)
    check(max(leaves) == LG_LEAVES and min(leaves) > 1,
          f"lossguide: leaves per tree {leaves}")
    loaded = xgbt.Booster(model_file=bst.save_raw())
    err = float(np.abs(loaded.predict(xgbt.DMatrix(Xte)) - preds).max())
    check(err <= 1e-5, f"lossguide: JSON round trip max abs err {err}")
    print(f"lossguide ({LG_LEAVES} leaves, max_depth 0): launches {got}; "
          f"median round {probe.median_ms():.1f} ms (incl. eval); leaves "
          f"{leaves}; auc {auc[0]:.6f} -> {auc[-1]:.6f}; JSON round trip "
          f"max abs err {err}")
    del bst, loaded
    grad, hess = create_objective("binary:logistic").get_gradient(
        torch.zeros(Xtr.shape[0], device=DEVICE), dtrain.label, None)
    k16 = phase_child_histograms(binned, grad, hess, LG_LEAVES)
    k2 = phase_child_histograms(binned, grad, hess, 31)
    del dtrain, dtest, binned, grad, hess
    torch.cuda.empty_cache()
    mono = "(%d)" % (1 if w[0] > 0 else -1)
    errs = {}
    for leaves_cut in (31, LG_LEAVES):
        params = {**LG_PARAMS, "max_leaves": leaves_cut, "subsample": 0.8,
                  "colsample_bynode": 0.8, "monotone_constraints": mono}
        errs[leaves_cut] = phase_card_vs_cpu(
            Xtr, ytr, Xte, name=f"lossguide {leaves_cut} leaves card vs CPU",
            params=params)
    out = dict(launches=got, auc=auc, logloss=res["test"]["logloss"],
               ms_per_round_median=probe.median_ms(), round_ms=probe.times,
               leaves=leaves, json_max_abs_err=err, child_hist_k16=k16,
               child_hist_k2=k2, walk=walk, card_vs_cpu=errs,
               phase_s=time.perf_counter() - t_phase)
    print(f"lossguide: {out['phase_s']:.1f} s")
    return out


def phase_dart(Xtr, ytr, Xte, yte):
    """DART at the DART tutorial's parameters for 50 rounds through
    ``train``: every round after the first walks the whole forest with its
    drops for the training margin (kernel B), every round walks it for the
    eval; C once, D 50 x 5, A never; held-out AUC in the last round above
    round 1's; some trees reweighted. Then 5 rounds at ``rate_drop`` 0.5
    and ``skip_drop`` 0 on the card and the CPU: the same trees and
    ``weight_drop``."""
    t_phase = time.perf_counter()
    dtrain = xgbt.DMatrix(Xtr, ytr)
    dtest = xgbt.DMatrix(Xte, yte)
    dtrain.get_binned(DEFAULT_MAX_BIN)
    probe = _RoundProbe()
    res = {}
    reset_launches()
    bst = xgbt.train(DART_PARAMS, dtrain, DART_ROUNDS,
                     evals=[(dtest, "test")], evals_result=res,
                     verbose_eval=False, callbacks=[probe])
    torch.cuda.synchronize()
    got = launches()
    want = {"A": 0, "C": 1, "D": DART_ROUNDS * DART_DEPTH}
    for k, v in want.items():
        check(got[k] == v, f"dart: kernel {k} launched {got[k]} times, "
                           f"want {v}")
    check(got["B"] >= 2 * DART_ROUNDS - 1,
          f"dart: kernel B launched {got['B']} times (a training and an "
          f"eval walk a round)")
    auc = res["test"]["auc"]
    check(auc[-1] > auc[0], f"dart: held-out AUC {auc}")
    wd = bst._gbm.weight_drop
    check(len(wd) == DART_ROUNDS and min(wd) < 1.0,
          f"dart: weight_drop {len(wd)} weights, smallest {min(wd)}")
    check(np.array_equal(bst.inplace_predict(Xte),
                         bst.predict(xgbt.DMatrix(Xte))),
          "dart: inplace_predict == predict")
    print(f"dart ({DART_ROUNDS} rounds, rate_drop 0.1, skip_drop 0.5): "
          f"launches {got}; median round {probe.median_ms():.1f} ms (incl. "
          f"the training walk and eval); {sum(x < 1.0 for x in wd)} of "
          f"{len(wd)} trees reweighted; auc {auc[0]:.6f} -> {auc[-1]:.6f}")
    del bst, dtrain, dtest
    torch.cuda.empty_cache()
    err = phase_card_vs_cpu(
        Xtr, ytr, Xte, name="dart card vs CPU", rounds=5,
        params={**DART_PARAMS, "rate_drop": 0.5, "skip_drop": 0.0})
    out = dict(launches=got, auc=auc, logloss=res["test"]["logloss"],
               ms_per_round_median=probe.median_ms(), round_ms=probe.times,
               reweighted=sum(x < 1.0 for x in wd), card_vs_cpu=err,
               phase_s=time.perf_counter() - t_phase)
    print(f"dart: {out['phase_s']:.1f} s")
    return out


def phase_random_forest(Xtr, ytr, Xte, yte):
    """A random forest at the random-forest tutorial's parameters: 100
    parallel trees in one round through ``train``: C once, D 100 x 5, A
    never, B once (the eval walk); 100 trees and one boosted round; the
    held-out margins' AUC above one tree's grown with the same parameters
    (the probabilities saturate);
    ``iteration_range=(0, 1)`` equal to the whole model. Then 4 parallel
    trees for 2 rounds on the card and the CPU: the same trees."""
    t_phase = time.perf_counter()
    dtrain = xgbt.DMatrix(Xtr, ytr)
    dtest = xgbt.DMatrix(Xte, yte)
    dtrain.get_binned(DEFAULT_MAX_BIN)
    res = {}
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bst = xgbt.train(RF_PARAMS, dtrain, 1, evals=[(dtest, "test")],
                     evals_result=res, verbose_eval=False)
    torch.cuda.synchronize()
    t_round = time.perf_counter() - t0
    got = launches()
    want = {"A": 0, "B": 1, "C": 1, "D": RF_TREES * RF_DEPTH}
    for k, v in want.items():
        check(got[k] == v, f"random forest: kernel {k} launched {got[k]} "
                           f"times, want {v}")
    check(bst._gbm.model.num_trees == RF_TREES
          and bst.num_boosted_rounds() == 1,
          f"random forest: {bst._gbm.model.num_trees} trees, "
          f"{bst.num_boosted_rounds()} rounds")
    preds = bst.predict(xgbt.DMatrix(Xte))
    check(np.array_equal(bst.predict(xgbt.DMatrix(Xte),
                                     iteration_range=(0, 1)), preds),
          "random forest: iteration_range (0, 1) == the whole model")
    one = xgbt.train({**RF_PARAMS, "num_parallel_tree": 1}, dtrain, 1,
                     verbose_eval=False)
    # the round's 100 leaf values add up at learning rate 1: the margins
    # reach |m| ~ 50, where float32's sigmoid is exactly 0 or 1, so the
    # AUC of the probabilities ties rows; the AUC of the margins does not
    auc, auc1 = float(_auc(bst, Xte, yte)), float(_auc(one, Xte, yte))
    saturated = float(np.mean((preds == 0.0) | (preds == 1.0)))
    check(auc > auc1, f"random forest: margin AUC {auc} vs one tree's {auc1}")
    print(f"random forest ({RF_TREES} trees, depth {RF_DEPTH}, subsample "
          f"0.8, colsample_bynode 0.8): launches {got}; the round "
          f"{t_round * 1e3:.1f} ms (incl. eval); held-out auc of the "
          f"margins {auc:.6f} against one tree's {auc1:.6f} (of the "
          f"probabilities {res['test']['auc'][-1]:.6f}, {saturated:.3f} of "
          f"them exactly 0 or 1)")
    del bst, one, dtrain, dtest
    torch.cuda.empty_cache()
    err = phase_card_vs_cpu(
        Xtr, ytr, Xte, name="random forest card vs CPU", rounds=2,
        params={**RF_PARAMS, "num_parallel_tree": 4})
    out = dict(launches=got, margin_auc=auc, one_tree_margin_auc=auc1,
               auc=res["test"]["auc"], saturated=saturated,
               round_ms=t_round * 1e3, card_vs_cpu=err,
               phase_s=time.perf_counter() - t_phase)
    print(f"random forest: {out['phase_s']:.1f} s")
    return out


def phase_inert_keys(Xtr, ytr):
    """One round with the keys that change nothing set grows the same tree
    as without them, with one warning for each."""
    dtrain = xgbt.DMatrix(Xtr, ytr)
    plain = xgbt.train(PARAMS_DEFAULT, dtrain, 1, verbose_eval=False)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = xgbt.train({**PARAMS_DEFAULT, **INERT_KEYS}, dtrain, 1,
                         verbose_eval=False)
    same_trees(heap_trees(got, 1), heap_trees(plain, 1), "inert keys")
    said = [str(c.message) for c in caught]
    check(len(said) == len(INERT_KEYS), f"inert keys: warnings {said}")
    print(f"inert keys {sorted(INERT_KEYS)}: the same tree; warned: {said}")
    return dict(keys=INERT_KEYS, warnings=said)


# ---------------------------------------------------------------------------
# SHAP, the linear booster and the estimators (phases 29-31)
# ---------------------------------------------------------------------------

#: the SHAP phase's row counts: contributions on every held-out row, the
#: card against the CPU on 4k (interactions on 1k), interactions on 10k
SHAP_CPU_ROWS, SHAP_CPU_INTER_ROWS, SHAP_INTER_ROWS = 4_000, 1_000, 10_000
#: the deep-path check: paths with more unique features than this take
#: the row DP on the lossguide forest (its deepest paths reach 12)
SHAP_DEEP_AT, SHAP_DEEP_ROWS = 8, 10_000
MAIN_PARAMS = {**PARAMS_DEFAULT, "max_depth": DEPTH,
               "max_bin": DEFAULT_MAX_BIN}


def _sync_s(fn):
    """``(result, seconds)`` of ``fn()`` ending in a device synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _table_build_s(bst, pair: bool = False):
    """Seconds to build every tree's mask tables (pair tables with
    ``pair``) on the card, with the host bookkeeping of the paths."""
    from xgboost_tpu_torch import interpret

    trees = bst._gbm.model.trees

    def build():
        for t in trees:
            plan = interpret.TreePlan(t)
            table = plan.D <= interpret._TABLE_MAX_D
            if table.any():
                interpret.leaf_tables(plan.select(table), DEVICE, pair)
    return _sync_s(build)[1]


def _shap_additive(name, bst, X, types=None, tol=1e-4, approx=False):
    """Contributions of ``X`` on the card against kernel B's margins (or
    the categorical walk's): row sums within ``tol``; ``(contribs, ms,
    max err)``."""
    d = xgbt.DMatrix(X, feature_types=types)
    margin = bst.predict(d, output_margin=True)
    c, s = _sync_s(lambda: bst.predict(d, pred_contribs=True,
                                       approx_contribs=approx))
    err = float(np.abs(c.sum(-1) - margin).max())
    check(np.isfinite(c).all() and err <= tol,
          f"{name}: contributions sum to the margins ({err})")
    return c, s * 1e3, err


def _shap_card_vs_cpu(name, bst, X, types=None, rounds=None):
    """The card's SHAP values against the CPU's (the same JSON model; its
    first ``rounds`` rounds if given): contributions and Saabas on
    ``SHAP_CPU_ROWS`` rows, interactions on ``SHAP_CPU_INTER_ROWS``, within
    1e-9. Returns the max error."""
    if rounds is not None:
        bst = bst[:rounds]
    cpu = xgbt.Booster(model_file=bst.save_raw(), device="cpu")
    errs = []
    for kw, rows in (({"pred_contribs": True}, SHAP_CPU_ROWS),
                     ({"pred_contribs": True, "approx_contribs": True},
                      SHAP_CPU_ROWS),
                     ({"pred_interactions": True}, SHAP_CPU_INTER_ROWS)):
        a = bst.predict(xgbt.DMatrix(X[:rows], feature_types=types), **kw)
        b = cpu.predict(xgbt.DMatrix(X[:rows], feature_types=types,
                                     device="cpu"), **kw)
        errs.append(float(np.abs(a - b).max()))
    check(max(errs) <= 1e-9, f"{name}: card vs CPU SHAP max err {errs}")
    return max(errs)


def phase_shap(Xtr, ytr, Xte, yte, cat):
    """SHAP on the card (``interpret.py``) on main-path models (1M x 50,
    max_bin 256, depth 6, 10 rounds): contributions on the 100k held-out
    rows summing to kernel B's margins within 1e-4 with no level kernel or
    walk launched by them; the card against the CPU within 1e-9; Saabas
    additive; interactions on 10k rows summing to the contributions within
    1e-6, symmetric; a 3-class model (``[n, 3, F+1]``), DART (tree
    weights), the categorical configuration (``cat``: its ``isin``), and
    phase 24's lossguide forest (255 leaves, no depth limit) whose longest
    paths take the row DP at ``_TABLE_MAX_D`` = 8, equal to the table
    path within 1e-8."""
    from xgboost_tpu_torch import interpret

    t_phase = time.perf_counter()
    out = {}
    dtrain = xgbt.DMatrix(Xtr, ytr)
    reset_launches()
    bst = xgbt.train(MAIN_PARAMS, dtrain, ROUNDS, verbose_eval=False)
    torch.cuda.synchronize()
    out["train_launches"] = launches()
    reset_launches()
    c, ms, err = _shap_additive("shap main", bst, Xte)
    got = launches()
    check(got == {"A": 0, "B": 1, "C": 0, "D": 0},
          f"shap main: launches {got} (one walk for the margins)")
    check(c.shape == (EVAL_ROWS, COLS + 1), f"shap main: shape {c.shape}")
    _, ms_approx, err_approx = _shap_additive("shap approx", bst, Xte,
                                              approx=True)
    di = xgbt.DMatrix(Xte[:SHAP_INTER_ROWS])
    inter, s_inter = _sync_s(lambda: bst.predict(di, pred_interactions=True))
    e_rows = float(np.abs(inter.sum(-1) - c[:SHAP_INTER_ROWS]).max())
    e_sym = float(np.abs(inter - inter.transpose(0, 2, 1)).max())
    check(e_rows <= 1e-6 and e_sym <= 1e-12,
          f"shap interactions: rows {e_rows}, symmetry {e_sym}")
    del inter
    table_ms = _table_build_s(bst) * 1e3
    pair_ms = _table_build_s(bst, pair=True) * 1e3
    cpu_err = _shap_card_vs_cpu("shap main", bst, Xte)
    print(f"shap main (10 depth-6 trees): contribs {EVAL_ROWS} rows "
          f"{ms:.1f} ms (sum vs kernel B's margins {err:.2e}), approx "
          f"{ms_approx:.1f} ms ({err_approx:.2e}), interactions "
          f"{SHAP_INTER_ROWS} rows {s_inter * 1e3:.1f} ms (rows {e_rows:.2e}"
          f", symmetry {e_sym:.2e}); table build {table_ms:.1f} ms, pair "
          f"tables {pair_ms:.1f} ms; card vs CPU {cpu_err:.2e}; launches "
          f"{got}")
    out["main"] = dict(contribs_ms=ms, approx_ms=ms_approx,
                       interactions_ms=s_inter * 1e3, table_build_ms=table_ms,
                       pair_table_build_ms=pair_ms, additivity_err=err,
                       approx_err=err_approx, interaction_rows_err=e_rows,
                       symmetry_err=e_sym, card_vs_cpu_err=cpu_err,
                       launches=got)
    del bst
    torch.cuda.empty_cache()
    # 3 classes, DART, categorical: additivity, shapes, card vs CPU
    rng = np.random.RandomState(5)
    W3 = rng.randn(COLS, 3).astype(np.float32)
    y3 = np.argmax(np.nan_to_num(Xtr) @ W3, 1).astype(np.float32)
    Xc, yc, Xcte, types = cat
    for name, params, X, y, Xe, ft, rounds in (
            ("shap 3 classes", {**MAIN_PARAMS, "objective": "multi:softprob",
                                "num_class": 3}, Xtr, y3, Xte, None,
             CPU_ROUNDS),
            ("shap dart", {**DART_PARAMS, "max_bin": DEFAULT_MAX_BIN}, Xtr,
             ytr, Xte, None, ROUNDS),
            ("shap categorical", MAIN_PARAMS, Xc, yc, Xcte, types, ROUNDS)):
        b = xgbt.train(params, xgbt.DMatrix(X, y, feature_types=ft), rounds,
                       verbose_eval=False)
        c, ms, err = _shap_additive(name, b, Xe, ft)
        want = ((EVAL_ROWS, 3, COLS + 1) if "classes" in name
                else (EVAL_ROWS, COLS + 1))
        check(c.shape == want, f"{name}: shape {c.shape}")
        cpu_err = _shap_card_vs_cpu(name, b, Xe, ft)
        extra = ""
        if "dart" in name:
            wd = b._gbm.weight_drop
            check(min(wd) < 1.0, f"{name}: some trees reweighted")
            extra = f"; {sum(x < 1.0 for x in wd)} of {len(wd)} reweighted"
        if "categorical" in name:
            ncat = sum(int(t.categorical_nodes().sum())
                       for t in b._gbm.model.trees)
            check(ncat > 0, f"{name}: categorical nodes")
            extra = f"; {ncat} categorical nodes"
        print(f"{name}: contribs {c.shape} {ms:.1f} ms, sum vs margins "
              f"{err:.2e}, card vs CPU {cpu_err:.2e}{extra}")
        out[name.split(" ", 1)[1]] = dict(contribs_ms=ms, additivity_err=err,
                                          card_vs_cpu_err=cpu_err)
        del b
        torch.cuda.empty_cache()
    # the lossguide forest: the table path, then the row DP for paths of
    # more than SHAP_DEEP_AT features
    b = xgbt.train(LG_PARAMS, dtrain, ROUNDS, verbose_eval=False)
    interpret.reset_path_counts()
    c, ms, err = _shap_additive("shap lossguide", b, Xte)
    counts = dict(interpret.path_counts)
    depth = max(t.max_depth() for t in b._gbm.model.trees)
    dd = xgbt.DMatrix(Xte[:SHAP_DEEP_ROWS])
    old = interpret._TABLE_MAX_D
    interpret._TABLE_MAX_D = SHAP_DEEP_AT
    interpret.reset_path_counts()
    try:
        deep, s_deep = _sync_s(lambda: b.predict(dd, pred_contribs=True))
    finally:
        interpret._TABLE_MAX_D = old
    forced = dict(interpret.path_counts)
    e_deep = float(np.abs(deep - c[:SHAP_DEEP_ROWS]).max())
    check(forced["deep"] > 0 and e_deep <= 1e-8,
          f"shap lossguide: {forced['deep']} paths through the row DP, "
          f"max err against the table path {e_deep}")
    # the CPU builds the 2^D tables of 255-leaf trees slowly: two rounds
    cpu_err = _shap_card_vs_cpu("shap lossguide", b, Xte, rounds=2)
    print(f"shap lossguide (255 leaves, deepest leaf at depth {depth}): "
          f"contribs {ms:.1f} ms, sum vs margins {err:.2e}; paths {counts} "
          f"at _TABLE_MAX_D {old}; at {SHAP_DEEP_AT}: {forced} on "
          f"{SHAP_DEEP_ROWS} rows, {s_deep * 1e3:.1f} ms, max err against "
          f"the table path {e_deep:.2e}; card vs CPU (2 rounds) "
          f"{cpu_err:.2e}")
    out["lossguide"] = dict(contribs_ms=ms, additivity_err=err,
                            depth=depth, paths=counts, forced_paths=forced,
                            deep_ms=s_deep * 1e3, deep_err=e_deep,
                            card_vs_cpu_err=cpu_err)
    del b, dtrain
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"shap: {out['phase_s']:.1f} s")
    return out


GBL_ROUNDS, GBL_CPU_ROUNDS = 20, 5
GBL_SELECTORS = [{"feature_selector": s} for s in
                 ("cyclic", "shuffle", "random", "greedy", "thrifty")] + [
    {"updater": "shotgun", "feature_selector": "cyclic"},
    {"updater": "shotgun", "feature_selector": "shuffle"}]


def _linear_target(X, w):
    """``0.5 X w`` plus noise of 0.1: the generator's coefficients halved
    (the base score 0.5 takes no intercept)."""
    rng = np.random.RandomState(9)
    return (np.nan_to_num(X) @ w * 0.5 + 0.5 + 0.1 * rng.randn(len(X))
            ).astype(np.float32)


def phase_gblinear(Xtr, ytr, Xte, yte, w):
    """The linear booster at 1M x 50 for 20 rounds with every selector:
    ``reg:squarederror`` on a linear target recovers the generating
    coefficients within 0.02, ``binary:logistic`` lowers the held-out
    logloss; no bins, no one-hot, no level kernel and no walk (A = B = C =
    D = 0); ms a round; then 5 rounds on 64k rows on the card and the CPU:
    weights within rtol 1e-6."""
    t_phase = time.perf_counter()
    ylin, ylin_te = _linear_target(Xtr, w), _linear_target(Xte, w)
    out = {}
    for objective, y, yv in (("reg:squarederror", ylin, ylin_te),
                             ("binary:logistic", ytr, yte)):
        dtrain, dtest = xgbt.DMatrix(Xtr, y), xgbt.DMatrix(Xte, yv)
        for sel in GBL_SELECTORS:
            name = f"{objective} {sel.get('updater', 'coord_descent')}/" \
                   f"{sel['feature_selector']}"
            params = {"booster": "gblinear", "objective": objective, **sel}
            probe, res = _RoundProbe(), {}
            reset_launches()
            bst = xgbt.train(params, dtrain, GBL_ROUNDS,
                             evals=[(dtest, "test")], evals_result=res,
                             verbose_eval=False, callbacks=[probe])
            got = launches()
            check(got == {"A": 0, "B": 0, "C": 0, "D": 0},
                  f"gblinear {name}: launches {got}")
            check(not dtrain._binned, f"gblinear {name}: no bins built")
            metric = next(iter(res["test"]))
            hist = res["test"][metric]
            check(hist[-1] < hist[0], f"gblinear {name}: {metric} {hist}")
            wt = bst._gbm.host_weights()[:, 0]
            coef_err = float(np.abs(wt[:-1] - 0.5 * w).max())
            if objective == "reg:squarederror":
                check(coef_err <= 0.02,
                      f"gblinear {name}: coefficients off by {coef_err}")
            print(f"gblinear {name}: median round {probe.median_ms():.1f} "
                  f"ms (incl. eval); {metric} {hist[0]:.6f} -> "
                  f"{hist[-1]:.6f}; coefficients vs 0.5 w max err "
                  f"{coef_err:.4f}; launches {got}")
            out[name] = dict(ms_per_round_median=probe.median_ms(),
                             round_ms=probe.times, metric=metric,
                             first=hist[0], last=hist[-1],
                             coef_err=coef_err, launches=got)
            del bst
        del dtrain, dtest
    errs = {}
    for objective, y in (("reg:squarederror", ylin), ("binary:logistic",
                                                       ytr)):
        for sel in GBL_SELECTORS:
            params = {"booster": "gblinear", "objective": objective, **sel}
            wts = [xgbt.train(params, xgbt.DMatrix(
                Xtr[:CPU_ROWS], y[:CPU_ROWS], device=dev), GBL_CPU_ROUNDS,
                verbose_eval=False)._gbm.host_weights()
                for dev in (DEVICE, "cpu")]
            ok = np.allclose(wts[0], wts[1], rtol=1e-6, atol=1e-7)
            e = float(np.abs(wts[0] - wts[1]).max())
            check(ok, f"gblinear card vs CPU {objective} {sel}: {e}")
            errs[f"{objective} {sel}"] = e
    print(f"gblinear card vs CPU ({CPU_ROWS} rows, {GBL_CPU_ROUNDS} rounds, "
          f"{len(errs)} runs): weights max abs err {max(errs.values()):.2e}")
    out["card_vs_cpu"] = errs
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"gblinear: {out['phase_s']:.1f} s")
    return out


def phase_sklearn(Xtr, ytr, Xte, yte, w):
    """The estimators on the card at the main path's width: an
    ``XGBClassifier`` (10 trees, depth 6, max_bin 256, eval set) grows
    ``train``'s trees with the main path's launches (C 1, D 60, A 0, B 10)
    and ``predict_proba`` equals ``Booster.predict``; an
    ``XGBRegressor(booster="gblinear")``'s ``coef_`` near the generator's;
    ``XGBRanker`` on the 200k all-pairs ranking data (held-out ndcg
    rising); an ``XGBRFClassifier`` of 100 trees at depth 5 in one round;
    ``config_context(verbosity=0)`` silences the port's warnings."""
    t_phase = time.perf_counter()
    out = {}
    kw = dict(n_estimators=ROUNDS, max_depth=DEPTH, max_bin=DEFAULT_MAX_BIN)
    reset_launches()
    clf, s = _sync_s(lambda: xgbt.XGBClassifier(**kw).fit(
        Xtr, ytr, eval_set=[(Xte, yte)]))
    got = launches()
    want = {"A": 0, "B": ROUNDS, "C": 1, "D": ROUNDS * DEPTH}
    check(got == want, f"XGBClassifier: launches {got}, want {want}")
    ref = xgbt.train({"objective": "binary:logistic", "max_depth": DEPTH,
                      "max_bin": DEFAULT_MAX_BIN}, xgbt.DMatrix(Xtr, ytr),
                     ROUNDS, verbose_eval=False)
    same_trees(heap_trees(clf.get_booster(), ROUNDS), heap_trees(ref, ROUNDS),
               "XGBClassifier vs train")
    proba = clf.predict_proba(Xte)
    check(proba.shape == (EVAL_ROWS, 2) and np.array_equal(
        proba[:, 1], ref.predict(xgbt.DMatrix(Xte))),
          "XGBClassifier: predict_proba == Booster.predict")
    acc = clf.score(Xte, yte)
    ll = clf.evals_result()["validation_0"]["logloss"]
    check(ll[-1] < ll[0], f"XGBClassifier: held-out logloss {ll}")
    print(f"XGBClassifier ({ROUNDS} trees, depth {DEPTH}, max_bin "
          f"{DEFAULT_MAX_BIN}): fit {s:.2f} s, launches {got}; the trees of "
          f"train; predict_proba == Booster.predict; accuracy {acc:.4f}, "
          f"logloss {ll[0]:.6f} -> {ll[-1]:.6f}")
    out["classifier"] = dict(fit_s=s, launches=got, accuracy=acc,
                             logloss=ll)
    del clf, ref
    torch.cuda.empty_cache()
    reg, s = _sync_s(lambda: xgbt.XGBRegressor(
        booster="gblinear", n_estimators=GBL_ROUNDS).fit(
            Xtr, _linear_target(Xtr, w)))
    coef_err = float(np.abs(reg.coef_ - 0.5 * w).max())
    check(reg.coef_.shape == (COLS,) and coef_err <= 0.02,
          f"XGBRegressor gblinear: coef_ off by {coef_err}")
    print(f"XGBRegressor(booster='gblinear'): fit {s:.2f} s, coef_ vs 0.5 w "
          f"max err {coef_err:.4f}, intercept_ {reg.intercept_}")
    out["gblinear_regressor"] = dict(fit_s=s, coef_err=coef_err)
    del reg
    X, y, sizes = _make_rank_data(ALL_PAIRS_ROWS + ALL_PAIRS_EVAL_ROWS, 8,
                                  32, seed=43)
    (Xr, yr, sr), (Xv, yv, sv) = _split_queries(X, y, sizes, ALL_PAIRS_ROWS)
    rk, s = _sync_s(lambda: xgbt.XGBRanker(
        n_estimators=ALL_PAIRS_ROUNDS, max_depth=DEPTH, learning_rate=0.1,
        eval_metric="ndcg@10").fit(Xr, yr, group=sr, eval_set=[(Xv, yv)],
                                   eval_group=[sv]))
    nd = rk.evals_result()["validation_0"]["ndcg@10"]
    check(nd[-1] > nd[0], f"XGBRanker: held-out ndcg@10 {nd}")
    print(f"XGBRanker ({Xr.shape[0]} rows in {len(sr)} queries, "
          f"{ALL_PAIRS_ROUNDS} rounds): fit {s:.2f} s, held-out ndcg@10 "
          f"{nd[0]:.6f} -> {nd[-1]:.6f}")
    out["ranker"] = dict(fit_s=s, ndcg=nd)
    del rk, X, Xr, Xv
    torch.cuda.empty_cache()
    reset_launches()
    rf, s = _sync_s(lambda: xgbt.XGBRFClassifier(
        n_estimators=RF_TREES, max_depth=RF_DEPTH).fit(Xtr, ytr))
    got = launches()
    check(rf.get_booster()._gbm.model.num_trees == RF_TREES
          and rf.get_booster().num_boosted_rounds() == 1,
          "XGBRFClassifier: 100 trees in one round")
    check(got["D"] == RF_TREES * RF_DEPTH and got["A"] == 0,
          f"XGBRFClassifier: launches {got}")
    p = rf.predict_proba(Xte)
    check(p.shape == (EVAL_ROWS, 2) and np.isfinite(p).all(),
          "XGBRFClassifier: probabilities")
    print(f"XGBRFClassifier ({RF_TREES} trees, depth {RF_DEPTH}): fit "
          f"{s:.2f} s, launches {got}")
    out["rf_classifier"] = dict(fit_s=s, launches=got)
    del rf
    torch.cuda.empty_cache()
    d = xgbt.DMatrix(Xtr, ytr)
    said = {}
    for verbosity in (1, 0):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            with xgbt.config_context(verbosity=verbosity):
                xgbt.train({**PARAMS_DEFAULT, **INERT_KEYS}, d, 1,
                           verbose_eval=False)
        said[verbosity] = len(caught)
    check(said == {1: len(INERT_KEYS), 0: 0},
          f"config_context(verbosity=0): warnings {said}")
    print(f"config_context: warnings at verbosity 1 / 0: {said[1]} / "
          f"{said[0]}")
    out["verbosity_warnings"] = said
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"sklearn: {out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# The other tree methods (phases 32-36): approx, exact, kernel A's global
# branch, the local histmaker and refresh
# ---------------------------------------------------------------------------

METHOD_ROUNDS = 5
APPROX_PARAMS = {**PARAMS_DEFAULT, "tree_method": "approx"}
LOCAL_PARAMS = {**PARAMS_DEFAULT, "updater": "grow_local_histmaker"}
EXACT_PARAMS = {"objective": "binary:logistic", "tree_method": "exact",
                "max_depth": DEPTH, "eta": 0.1,
                "eval_metric": ["logloss", "auc"]}
# UCI Covertype (covtype.info): 581,012 rows; its ten quantitative columns'
# documented ranges (elevation, aspect, slope, the distances to hydrology
# (horizontal, vertical), roadways, three hillshades, fire points), then 4
# wilderness and 40 soil one-hot columns
COVTYPE_ROWS = 581_012
COVTYPE_RANGES = ((1859, 3858), (0, 360), (0, 66), (0, 1397), (-173, 601),
                  (0, 7117), (0, 254), (0, 254), (0, 254), (0, 7173))
WIDE_ROWS, WIDE_COLS, WIDE_VALUES = 1_000_000, 8, 16_000


def _make_covtype(rows: int, seed: int = 42):
    """Covertype-shaped rows, synthetic from ``seed``: the ten integer
    columns uniform over their documented ranges, one wilderness area and
    one soil type per row (one-hot), and LIBSVM's ``covtype.binary`` label,
    the largest class (Lodgepole Pine, 48.8% of the rows) against the
    rest: the top 48.8% of a score of elevation (a band around 2,950 m),
    slope, aspect, the road distance and per-area and per-soil effects,
    plus noise. Returns ``(X [rows, 54] float32, y)``."""
    rng = np.random.RandomState(seed)
    X = np.zeros((rows, 54), np.float32)
    for c, (lo, hi) in enumerate(COVTYPE_RANGES):
        X[:, c] = rng.randint(lo, hi + 1, rows)
    area, soil = rng.randint(0, 4, rows), rng.randint(0, 40, rows)
    X[np.arange(rows), 10 + area] = 1.0
    X[np.arange(rows), 14 + soil] = 1.0
    score = (-((X[:, 0] - 2950.0) / 300.0) ** 2 - 0.02 * X[:, 2]
             + 0.3 * np.cos(np.radians(X[:, 1])) + X[:, 5] / 7117.0
             + rng.randn(4)[area] + 0.7 * rng.randn(40)[soil]
             + 0.5 * rng.randn(rows))
    y = (score > np.quantile(score, 1.0 - 0.488)).astype(np.float32)
    return X, y


def phase_wide_levels(name: str, binned, label):
    """Kernel A against its plain version, bitwise (and twice), at every
    level of a real tree (round 0's logistic gradients) on ``binned`` at
    its own width B, timed beside the plain version, one ``index_add_``
    and its byte bound; the branch it takes (shared tiles, or the
    global-memory adds where one node's ``[2, B]`` int64 tile exceeds
    shared memory)."""
    bins, cuts = binned.bins, binned.cut_values
    bins_t = binned.feature_major()
    n, F = bins.shape
    B = binned.cuts.max_bin
    bs = bins.element_size()
    optin = getattr(torch.cuda.get_device_properties(DEVICE),
                    "shared_memory_per_block_optin", None)
    branch = ("unknown" if optin is None else
              "global-memory" if 2 * B * 8 > optin else "shared tiles")
    grad, hess = create_objective("binary:logistic").get_gradient(
        torch.zeros(n, device=DEVICE), label, None)
    gq = hk.quantize_gradients(grad, hess)
    cfg = GrowParams(max_depth=DEPTH, split=SplitParams())
    st = _init_state(cfg, gq.totals())
    pos = torch.zeros((n, 1), dtype=torch.int32, device=DEVICE)
    levels = []
    for lvl in range(DEPTH):
        K = 1 << lvl
        kw = dict(K=K, Kp=K >> 1, B=B, d=lvl)
        pa, ha = hk._fused_level_cuda(bins, pos, gq, st.ptab, bins_t=bins_t,
                                      **kw)
        pa2, ha2 = hk._fused_level_cuda(bins, pos, gq, st.ptab, **kw)
        pp, hp = hk._fused_level_plain(bins, pos, gq, st.ptab, **kw)
        torch.cuda.synchronize()
        tag = f"{name} B={B} level {lvl}"
        check(torch.equal(pa, pp) and torch.equal(ha, hp),
              f"{tag}: kernel A == plain")
        check(torch.equal(pa2, pa) and torch.equal(ha2, ha),
              f"{tag}: kernel A twice")
        del pa2, ha2, pp, hp

        def run():
            return hk.fused_level(bins, pos, gq, st.ptab, bins_t=bins_t,
                                  **kw)

        ms = time_ms(run, reps=10)
        k_ms = kernel_ms(run, "A", reps=10)
        plain_ms = time_ms(lambda: hk._fused_level_plain(
            bins, pos, gq, st.ptab, **kw), reps=3, warmup=1)
        lib_ms = _index_add_ms(bins, pa[:, 0].long() - (K - 1), grad, hess,
                               K, B, reps=10)
        bnd, by = level_bounds(n, F, 0, B, bs, lvl)[1]
        print(f"{tag} (K={K}, {branch}): kernel A {ms:.4f} ms (alone "
              f"{k_ms} ms)  plain {plain_ms:.4f} ms  index_add_ "
              f"{lib_ms:.4f} ms  bound {bnd:.4f} ms ({by}) | bitwise equal")
        levels.append(dict(level=lvl, ms=ms, kernel_ms=k_ms,
                           plain_ms=plain_ms, library_ms=lib_ms,
                           bound_ms=bnd, bound_by=by))
        lane = (torch.arange(2 * K, device=DEVICE) >= K).long()[None, :, None]
        st = _level_update(st, gq.dequantize(ha, lane), cuts, cfg, lvl)
        pos = pa
    kms = [x["kernel_ms"] for x in levels]
    return dict(B=B, rows=n, features=F, branch=branch,
                ms=_mean(levels, "ms"),
                kernel_ms=None if None in kms else sum(kms) / len(kms),
                plain_ms=_mean(levels, "plain_ms"),
                library_ms=_mean(levels, "library_ms"),
                bound_ms=_mean(levels, "bound_ms"), bound_by=by,
                max_abs_err=0.0, levels=levels)


def _method_run(name, params, dtrain, evals, rounds, want, metric="auc"):
    """``train`` with ``evals`` and a round probe; the launches must equal
    ``want`` (kernel B: at least ``want["B"]``). Returns the Booster, the
    history of ``metric`` on the last eval set, the launches and the
    probe."""
    reset_launches()
    probe, res = _RoundProbe(), {}
    bst = xgbt.train(params, dtrain, rounds, evals=evals, evals_result=res,
                     verbose_eval=False, callbacks=[probe])
    torch.cuda.synchronize()
    got = launches()
    for k, v in want.items():
        ok = got[k] >= v if k == "B" else got[k] == v
        check(ok, f"{name}: kernel {k} launched {got[k]} times, want {v}")
    return bst, res[evals[-1][1]][metric], got, probe


def phase_approx(Xtr, ytr, Xte, yte, c256):
    """``tree_method="approx"`` at ``bench.py``'s reference-default
    configuration for 10 rounds: every round sketches a new matrix from
    its hessians (the weighted CDF on the host) and builds its one-hot
    (kernel C), so C 10, D 60 (or, where the plan gives the construct
    route, A 60), B at least 10; held-out AUC >= 0.80 and rising; the
    sketch timed alone (``build_binned``, and its host prefix sum); the
    card against the CPU on 64k rows."""
    t_phase = time.perf_counter()
    dtrain, dtest = xgbt.DMatrix(Xtr, ytr), xgbt.DMatrix(Xte, yte)
    reset_launches()
    probe, res = _RoundProbe(), {}
    bst = xgbt.train(APPROX_PARAMS, dtrain, ROUNDS, evals=[(dtest, "test")],
                     evals_result=res, verbose_eval=False, callbacks=[probe])
    torch.cuda.synchronize()
    got = launches()
    hoisted = dict(A=0, C=ROUNDS, D=ROUNDS * DEPTH)
    route = ("hoisted" if all(got[k] == v for k, v in hoisted.items())
             else "construct")
    want = hoisted if route == "hoisted" else dict(A=ROUNDS * DEPTH, C=0, D=0)
    for k, v in want.items():
        check(got[k] == v, f"approx: kernel {k} launched {got[k]} times, "
                           f"want {v} ({route} route)")
    check(got["B"] >= ROUNDS, f"approx: kernel B launched {got['B']} times")
    auc = res["test"]["auc"]
    check(auc[-1] >= 0.80 and auc[-1] > auc[0], f"approx: AUC {auc}")
    del bst
    _, hess = create_objective("binary:logistic").get_gradient(
        torch.zeros(len(ytr), device=DEVICE), dtrain.label, None)
    sketch_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bm = dtrain.build_binned(DEFAULT_MAX_BIN, hess)
        torch.cuda.synchronize()
        sketch_ms.append((time.perf_counter() - t0) * 1e3)
        del bm
    sw = torch.rand((COLS, len(ytr)), device=DEVICE)
    cdf_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _sequential_cdf(sw, False)
        torch.cuda.synchronize()
        cdf_ms.append((time.perf_counter() - t0) * 1e3)
    del sw, hess, dtrain, dtest
    torch.cuda.empty_cache()
    print(f"approx (max_bin {DEFAULT_MAX_BIN}, {route} route): launches "
          f"{got}; median round {probe.median_ms():.1f} ms (incl. eval); "
          f"sketch (build_binned) {statistics.median(sketch_ms):.1f} ms, "
          f"its host prefix sum [{COLS}, {len(ytr)}] "
          f"{statistics.median(cdf_ms):.1f} ms; kernel C per round as the "
          f"reference-default matrix's ({c256['ms']:.4f} ms); auc "
          f"{auc[0]:.6f} -> {auc[-1]:.6f}")
    err = phase_card_vs_cpu(Xtr, ytr, Xte, name="approx card vs CPU",
                            params=APPROX_PARAMS)
    cpu_launches = launches()
    check(cpu_launches["C"] == CPU_ROUNDS,
          f"approx card vs CPU: kernel C {cpu_launches['C']} times on the "
          "card, once a round")
    out = dict(route=route, launches=got, auc=auc,
               logloss=res["test"]["logloss"],
               ms_per_round_median=probe.median_ms(), round_ms=probe.times,
               sketch_ms=sketch_ms, host_prefix_sum_ms=cdf_ms,
               card_vs_cpu=err, card_vs_cpu_launches=cpu_launches,
               phase_s=time.perf_counter() - t_phase)
    print(f"approx: {out['phase_s']:.1f} s")
    return out


def phase_exact():
    """``tree_method="exact"`` on Covertype-shaped data (``_make_covtype``,
    581,012 x 54): B the widest column's distinct count plus one (~7,175,
    int16 bins) and the hoist plan 0, so 5 rounds launch A 30 times, C and
    D never; the training logloss at or below a ``hist`` run's at max_bin
    64 (exact has every candidate hist has); kernel A bitwise equal to its
    plain version at all 6 levels of a tree at this width; then 64k rows:
    kernels C and D (a partial hoist at this width) and A against their
    plain versions at every level (``phase_level_kernels``), and the card
    against the CPU."""
    t_phase = time.perf_counter()
    X, y = _make_covtype(COVTYPE_ROWS)
    dtrain = xgbt.DMatrix(X, y)
    t0 = time.perf_counter()
    binned = dtrain.get_binned_exact()
    torch.cuda.synchronize()
    t_cuts = time.perf_counter() - t0
    B = binned.cuts.max_bin
    plan = hk.hoist_plan(hk.onehot_rows(COVTYPE_ROWS), 54, B, DEVICE)
    print(f"exact: Covertype-shaped {COVTYPE_ROWS} x 54, B = {B} "
          f"({binned.bins.dtype}), exact cuts and bins {t_cuts:.2f} s, "
          f"hoist plan {plan}")
    check(binned.bins.dtype == torch.int16 and 7000 < B <= 7175,
          f"exact: B = {B}, bins {binned.bins.dtype}")
    check(plan == 0, f"exact: hoist plan {plan}, want 0")
    evals = [(dtrain, "train")]
    want = dict(A=METHOD_ROUNDS * DEPTH, C=0, D=0)
    bst, logloss, got, probe = _method_run(
        "exact", EXACT_PARAMS, dtrain, evals, METHOD_ROUNDS, want, "logloss")
    del bst
    hist_params = {**EXACT_PARAMS, "tree_method": "hist", "max_bin": 64}
    bst, hist_logloss, hist_got, _ = _method_run(
        "hist at max_bin 64", hist_params, dtrain, evals, METHOD_ROUNDS,
        dict(A=0, C=1, D=METHOD_ROUNDS * DEPTH), "logloss")
    del bst
    check(logloss[-1] <= hist_logloss[-1] and logloss[-1] < logloss[0],
          f"exact training logloss {logloss} against hist's {hist_logloss}")
    print(f"exact: launches {got}; median round {probe.median_ms():.1f} ms "
          f"(incl. eval); training logloss {logloss[0]:.6f} -> "
          f"{logloss[-1]:.6f} (hist at max_bin 64: {hist_logloss[-1]:.6f})")
    levels = phase_wide_levels("exact", binned, dtrain.label)
    del binned, dtrain
    torch.cuda.empty_cache()
    d64 = xgbt.DMatrix(X[:CPU_ROWS], y[:CPU_ROWS])
    b64 = d64.get_binned_exact()
    c64k, a64k, d64k = phase_level_kernels(d64, b64.cuts.max_bin,
                                           prefix="exact 64k ", binned=b64)
    del d64, b64
    torch.cuda.empty_cache()
    err = phase_card_vs_cpu(X, y, X[CPU_ROWS:CPU_ROWS + 10_000],
                            name="exact card vs CPU", params=EXACT_PARAMS,
                            rounds=CUT_CPU_ROUNDS)
    card = launches()
    check(card["C"] == 1 and card["D"] == CUT_CPU_ROUNDS * DEPTH
          and card["A"] == 0,
          f"exact card vs CPU: launches {card} (a partial hoist at 64k)")
    out = dict(B=B, rows=COVTYPE_ROWS, launches=got,
               training_logloss=logloss, hist_bin64_logloss=hist_logloss,
               hist_bin64_launches=hist_got,
               ms_per_round_median=probe.median_ms(), round_ms=probe.times,
               exact_cuts_s=t_cuts, levels_A=levels, levels_64k=dict(
                   C=c64k, A=a64k, D=d64k), card_vs_cpu=err,
               card_vs_cpu_launches=card,
               phase_s=time.perf_counter() - t_phase)
    print(f"exact: {out['phase_s']:.1f} s")
    return out


def phase_wide_bins():
    """Kernel A on its global-memory branch: 1M x 8 with one column of
    16,000 distinct values, binned by ``compute_exact_cuts`` at B =
    16,001, against its plain version at levels 0-5."""
    rng = np.random.RandomState(5)
    X = rng.randint(0, 100, (WIDE_ROWS, WIDE_COLS)).astype(np.float32)
    X[:, 0] = rng.randint(0, WIDE_VALUES, WIDE_ROWS)
    y = (X[:, 0] / WIDE_VALUES + X[:, 1] / 100.0
         + 0.3 * rng.randn(WIDE_ROWS) > 1.0).astype(np.float32)
    d = xgbt.DMatrix(X, y)
    binned = d.get_binned_exact()
    check(binned.cuts.max_bin == WIDE_VALUES + 1,
          f"wide bins: B = {binned.cuts.max_bin}")
    out = phase_wide_levels("wide bins", binned, d.label)
    check(out["branch"] != "shared tiles",
          f"wide bins: kernel A took the {out['branch']} branch")
    return out


def phase_local(Xtr, ytr, Xte, yte):
    """``updater="grow_local_histmaker"`` at the reference-default
    configuration for 5 rounds: every level sketches each node's cuts on
    the card and builds its histogram through kernel A at ``d = 0``, so A
    6 times a tree, C and D never, B at least 5; held-out AUC >= 0.80 and
    rising; the card against the CPU on 64k rows."""
    t_phase = time.perf_counter()
    dtrain, dtest = xgbt.DMatrix(Xtr, ytr), xgbt.DMatrix(Xte, yte)
    want = dict(A=METHOD_ROUNDS * DEPTH, B=METHOD_ROUNDS, C=0, D=0)
    bst, auc, got, probe = _method_run(
        "local histmaker", LOCAL_PARAMS, dtrain, [(dtest, "test")],
        METHOD_ROUNDS, want)
    check(auc[-1] >= 0.80 and auc[-1] > auc[0],
          f"local histmaker: AUC {auc}")
    check(not dtrain._binned, "local histmaker: no global matrix built")
    print(f"local histmaker (max_bin {DEFAULT_MAX_BIN}): launches {got}; "
          f"median round {probe.median_ms():.1f} ms (incl. eval); auc "
          f"{auc[0]:.6f} -> {auc[-1]:.6f}")
    del bst, dtrain, dtest
    torch.cuda.empty_cache()
    err = phase_card_vs_cpu(Xtr, ytr, Xte, name="local histmaker card vs CPU",
                            params=LOCAL_PARAMS)
    out = dict(launches=got, auc=auc, ms_per_round_median=probe.median_ms(),
               round_ms=probe.times, card_vs_cpu=err,
               phase_s=time.perf_counter() - t_phase)
    print(f"local histmaker: {out['phase_s']:.1f} s")
    return out


def phase_refresh(bst, Xte, yte, w):
    """``process_type="update"``: the reference-default path's 10-tree
    model refreshed on a second 1M sample of the generator, with
    ``refresh_leaf`` 1 and 0, the held-out rows evaluated every round:
    still 10 trees, their statistics new (and with ``refresh_leaf`` 1
    their leaves), the eval set's cached margins equal to a fresh kernel
    B walk of the refreshed forest (no stale cache); the card against the
    CPU on 64k rows (the same model bytes); the standalone ``prune`` and
    an unknown updater raising the JAX package's errors."""
    t_phase = time.perf_counter()
    rng = np.random.RandomState(7)
    X2 = rng.randn(ROWS, COLS).astype(np.float32)
    y2 = (X2 @ w * 0.5 + rng.randn(ROWS).astype(np.float32) > 0
          ).astype(np.float32)
    d2, dtest = xgbt.DMatrix(X2, y2), xgbt.DMatrix(Xte, yte)
    Xt = torch.as_tensor(Xte, device=DEVICE)
    old = bst._gbm.model.trees
    out = {}
    for leaf in (1, 0):
        params = {**PARAMS_DEFAULT, "process_type": "update",
                  "refresh_leaf": leaf}
        reset_launches()
        probe, res = _RoundProbe(), {}
        upd = xgbt.train(params, d2, ROUNDS, xgb_model=bst,
                         evals=[(dtest, "test")], evals_result=res,
                         verbose_eval=False, callbacks=[probe])
        torch.cuda.synchronize()
        got = launches()
        check(got["A"] == got["C"] == got["D"] == 0 and got["B"] >= ROUNDS,
              f"refresh_leaf {leaf}: launches {got}")
        new = upd._gbm.model.trees
        check(len(new) == len(old) == ROUNDS,
              f"refresh_leaf {leaf}: {len(new)} trees")
        moved = [not np.array_equal(a.sum_hessian, b.sum_hessian)
                 for a, b in zip(old, new)]
        leaves_moved = [not np.array_equal(a.split_conditions,
                                           b.split_conditions)
                        for a, b in zip(old, new)]
        check(all(moved) and (all(leaves_moved) if leaf
                              else not any(leaves_moved)),
              f"refresh_leaf {leaf}: statistics / leaves refreshed")
        cached = upd._predict_margin(dtest)
        base = torch.full_like(cached, upd._base_margin_val)
        fresh = predict_margin(stack_forest(new, upd._gbm.model.tree_info, 1,
                                            DEVICE), Xt, base)
        torch.cuda.synchronize()
        err = float((cached - fresh).abs().max())
        check(err <= 1e-5, f"refresh_leaf {leaf}: the eval margins against "
                           f"a fresh walk, max abs err {err}")
        ll = res["test"]["logloss"]
        print(f"refresh (refresh_leaf {leaf}, {ROUNDS} trees on a second "
              f"1M sample): launches {got}; median round "
              f"{probe.median_ms():.1f} ms (incl. eval); held-out logloss "
              f"{ll[0]:.6f} -> {ll[-1]:.6f}; eval margins == a fresh kernel "
              f"B walk (max abs err {err})")
        out[f"refresh_leaf_{leaf}"] = dict(
            launches=got, logloss=ll, ms_per_round_median=probe.median_ms(),
            round_ms=probe.times, fresh_walk_max_abs_err=err)
        del upd
    raw = []
    for dev in (DEVICE, torch.device("cpu")):
        d = xgbt.DMatrix(X2[:CPU_ROWS], y2[:CPU_ROWS], device=dev)
        base_model = xgbt.Booster(model_file=bst.save_raw(), device=dev)
        raw.append(xgbt.train({**PARAMS_DEFAULT, "process_type": "update"},
                              d, ROUNDS, xgb_model=base_model,
                              verbose_eval=False).save_raw())
    check(raw[0] == raw[1], "refresh card vs CPU: the same model bytes")
    for params, exc in (({"updater": "prune"}, NotImplementedError),
                        ({"updater": "grow_bogus"}, ValueError)):
        try:
            xgbt.train({**PARAMS_DEFAULT, **params}, d2, 1,
                       verbose_eval=False)
        except exc as e:
            print(f"refresh: {params} raises {type(e).__name__}: {e}")
        else:
            raise RuntimeError(f"check failed: {params} did not raise")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"refresh: card == CPU on {CPU_ROWS} rows (model bytes); "
          f"{out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Sparse input and external memory
# ---------------------------------------------------------------------------

#: Kaggle's Bosch Production Line Performance ``train_numeric.csv`` (the
#: shape XGBoost's GPU paper trains on: Mitchell & Frank, PeerJ CS 2017):
#: rows, numeric features, the stored share and the failure rate
BOSCH_ROWS, BOSCH_COLS, BOSCH_DENSITY, BOSCH_POSITIVE = (1_183_747, 968, 0.19,
                                                         0.0058)
BOSCH_EVAL, BOSCH_ROUNDS, BOSCH_SIGNAL = 100_000, 5, 20
SPARSE_PARAMS = {"objective": "binary:logistic", "max_depth": DEPTH,
                 "max_bin": DEFAULT_MAX_BIN, "eta": 0.1, **METRICS}
#: the external-memory phase: the main path's rows fed as batches, paged
EXT_BATCHES, EXT_PAGE_ROWS = 8, 262_144
EXT_CPU_PAGE_ROWS = 16_384


def _make_bosch(rows: int, seed: int = 42):
    """``(csr, y)``: a ``rows`` x 968 float32 CSR with about 19% of its
    entries stored (each independently, in chunks of 65,536 rows), standard
    normal values and 0.1% of them explicit zeros; the label is a linear
    score over ``BOSCH_SIGNAL`` columns (absent entries count 0) plus
    noise, its top ``BOSCH_POSITIVE`` share positive (Bosch's failure
    rate)."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    counts, cols = [], []
    for lo in range(0, rows, 65_536):
        mask = rng.random((min(65_536, rows - lo), BOSCH_COLS),
                          dtype=np.float32) < BOSCH_DENSITY
        counts.append(mask.sum(axis=1))
        cols.append(np.nonzero(mask)[1].astype(np.int32))
    indptr = np.zeros(rows + 1, np.int64)
    np.cumsum(np.concatenate(counts), out=indptr[1:])
    data = rng.standard_normal(int(indptr[-1]), dtype=np.float32)
    data[rng.random(data.size, dtype=np.float32) < 0.001] = 0.0
    m = sp.csr_matrix((data, np.concatenate(cols), indptr),
                      shape=(rows, BOSCH_COLS))
    w = np.zeros(BOSCH_COLS, np.float32)
    w[rng.choice(BOSCH_COLS, BOSCH_SIGNAL, replace=False)] = rng.standard_normal(
        BOSCH_SIGNAL, dtype=np.float32)
    score = np.asarray(m @ w).ravel() + 0.5 * rng.standard_normal(rows)
    y = (score > np.quantile(score, 1.0 - BOSCH_POSITIVE)).astype(np.float32)
    return m, y


def _dense_of(m):
    """A CSR's values dense, NaN where absent."""
    out = np.full(m.shape, np.nan, np.float32)
    rows = np.repeat(np.arange(m.shape[0]), np.diff(m.indptr))
    out[rows, m.indices] = m.data
    return out


def _host_rss_gb():
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def phase_sparse():
    """The Bosch-shaped CSR (``_make_bosch``) through the entry points at
    max_bin 256, depth 6, eta 0.1, 5 rounds, AUC + logloss on 100k held-out
    CSR rows: the CSR matrix and a dense NaN matrix of the same values, both
    on the card, give identical cuts, bins, trees (JSON) and predictions;
    the CSR matrix's dense ``data`` is never made; CSR ``inplace_predict``
    equals dense; held-out AUC rises."""
    t0 = time.perf_counter()
    m, y = _make_bosch(BOSCH_ROWS + BOSCH_EVAL)
    mtr, ytr, mte, yte = (m[:BOSCH_ROWS], y[:BOSCH_ROWS], m[BOSCH_ROWS:],
                          y[BOSCH_ROWS:])
    del m
    t_gen = time.perf_counter() - t0
    stored = mtr.nnz / (BOSCH_ROWS * BOSCH_COLS)
    print(f"sparse: Bosch-shaped CSR {BOSCH_ROWS} x {BOSCH_COLS}, {stored:.4f}"
          f" stored ({mtr.nnz} values, {int((mtr.data == 0).sum())} explicit "
          f"zeros), {ytr.mean():.4f} positive; made in {t_gen:.1f} s")
    out = {"rows": BOSCH_ROWS, "cols": BOSCH_COLS, "stored": stored,
           "positive": float(ytr.mean())}
    runs = {}
    for kind in ("csr", "dense"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d = xgbt.DMatrix(mtr if kind == "csr" else _dense_of(mtr), ytr)
        binned = d.get_binned(DEFAULT_MAX_BIN)
        torch.cuda.synchronize()
        t_ingest = time.perf_counter() - t0
        torch.cuda.empty_cache()  # the sketch's transients
        dte = xgbt.DMatrix(mte, yte)
        res = {}
        probe = _RoundProbe()
        bst = xgbt.train(SPARSE_PARAMS, d, BOSCH_ROUNDS,
                         evals=[(dte, "test")], evals_result=res,
                         callbacks=[probe], verbose_eval=False)
        got = launches()
        onehot = binned.fused_onehot()
        fh = 0 if onehot is None else onehot.shape[0] // DEFAULT_MAX_BIN
        runs[kind] = dict(d=d, bst=bst, binned=binned)
        auc = res["test"]["auc"]
        out[kind] = dict(ingest_s=t_ingest, hoisted_features=fh,
                         launches=got, ms_per_round=probe.median_ms(),
                         round_ms=probe.times, auc=auc,
                         logloss=res["test"]["logloss"],
                         device_peak_gb=torch.cuda.max_memory_allocated()
                         / 2**30, host_peak_rss_gb=_host_rss_gb())
        print(f"sparse ({kind}): ingest {t_ingest:.2f} s, hoist plan "
              f"{fh}/{BOSCH_COLS}, launches {got}, median round "
              f"{probe.median_ms():.1f} ms (with eval), auc {auc[0]:.6f} -> "
              f"{auc[-1]:.6f}, device peak "
              f"{out[kind]['device_peak_gb']:.2f} GiB, host peak RSS "
              f"{out[kind]['host_peak_rss_gb']:.2f} GiB")
        check(auc[-1] > auc[0], f"sparse ({kind}): held-out AUC rises {auc}")
        check(got["C"] == (1 if fh else 0) and got["D"] == (
            BOSCH_ROUNDS * DEPTH if fh else 0) and got["A"] == (
            0 if fh else BOSCH_ROUNDS * DEPTH) and got["B"] >= BOSCH_ROUNDS,
            f"sparse ({kind}): launches {got}")
    cs, ds = runs["csr"], runs["dense"]
    check(np.array_equal(cs["binned"].cuts.values, ds["binned"].cuts.values),
          "sparse: CSR cuts == dense cuts")
    check(torch.equal(cs["binned"].bins, ds["binned"].bins),
          "sparse: CSR bins == dense bins")
    check(cs["bst"].save_raw() == ds["bst"].save_raw(),
          "sparse: CSR trees == dense trees (JSON)")
    check(np.array_equal(cs["bst"].predict(cs["d"]),
                         ds["bst"].predict(ds["d"])),
          "sparse: training predictions equal")
    dense_te = _dense_of(mte)
    p_csr = cs["bst"].predict(xgbt.DMatrix(mte))
    check(np.array_equal(p_csr, ds["bst"].predict(xgbt.DMatrix(dense_te))),
          "sparse: held-out predict, CSR rows == dense rows")
    check(cs["d"]._data is None, "sparse: the CSR matrix's data never made")
    reset_launches()
    t0 = time.perf_counter()
    inplace = cs["bst"].inplace_predict(mte)
    t_inplace = time.perf_counter() - t0
    check(predict_margin.launches == -(-BOSCH_EVAL // 65_536),
          f"sparse: CSR inplace_predict launches {predict_margin.launches}")
    check(np.array_equal(inplace, cs["bst"].inplace_predict(dense_te)),
          "sparse: CSR inplace_predict == dense inplace_predict")
    check(np.array_equal(inplace, p_csr), "sparse: inplace == predict")
    out["inplace_csr_s"] = t_inplace
    print(f"sparse: CSR and dense: identical cuts, bins, trees and "
          f"predictions; CSR inplace_predict of {BOSCH_EVAL} rows "
          f"{t_inplace * 1e3:.1f} ms, equal to dense")
    del runs, ds
    torch.cuda.empty_cache()
    out["levels"] = phase_sparse_levels(cs["binned"], ytr)
    return out


def phase_sparse_levels(binned, y):
    """Both level routes at F = 968 (the Bosch-shaped bins, round 0's
    logistic gradients, the tables of a real grown tree): kernel D over the
    hoist plan's one-hot (its unhoisted features built every level) and
    kernel A over the feature-major bins, bitwise equal to each other at
    every level, each timed beside its bound: the route the plan picks
    against the one it does not."""
    B, bins = DEFAULT_MAX_BIN, binned.bins
    n, F = bins.shape
    onehot = binned.fused_onehot()
    Fh = onehot.shape[0] // B
    bins_t = hk.feature_major(bins)
    g = torch.as_tensor(0.5 - y, device=DEVICE)
    gq = hk.quantize_gradients(g, torch.full_like(g, 0.25))
    cfg = GrowParams(max_depth=DEPTH)
    st = _init_state(cfg, gq.totals(), B, F)
    pos = torch.zeros((n, 1), dtype=torch.int32, device=DEVICE)
    levels = []
    for d in range(DEPTH):
        K = 1 << d
        kw = dict(K=K, Kp=K >> 1, B=B, d=d)
        pD, hD = hk._hoisted_level_cuda(bins, onehot, pos, gq, st.ptab, **kw)
        pA, hA = hk._fused_level_cuda(bins, pos, gq, st.ptab, bins_t=bins_t,
                                      **kw)
        check(torch.equal(pD, pA) and torch.equal(hD, hA),
              f"sparse levels: level {d} at F = {F}: kernel D == kernel A")
        d_ms = time_ms(lambda: hk._hoisted_level_cuda(
            bins, onehot, pos, gq, st.ptab, **kw), reps=3, warmup=1)
        a_ms = time_ms(lambda: hk._fused_level_cuda(
            bins, pos, gq, st.ptab, bins_t=bins_t, **kw), reps=5, warmup=1)
        (d_bound, d_by), (a_bound, a_by) = level_bounds(n, F, Fh, B, 2, d)
        levels.append(dict(D_ms=d_ms, D_bound_ms=d_bound, D_bound_by=d_by,
                           A_ms=a_ms, A_bound_ms=a_bound, A_bound_by=a_by))
        pos = pD
        st = _level_update(st, gq.dequantize(hD, hk.level_lanes(K, DEVICE)),
                           binned.cut_values, cfg, d)
    print(f"sparse levels at {n} x {F}, hoist plan {Fh}: D == A at levels "
          f"0-5; D ms " + ", ".join(f"{x['D_ms']:.1f}" for x in levels)
          + f" (bound {levels[0]['D_bound_ms']:.2f}); A ms " + ", ".join(
              f"{x['A_ms']:.2f}" for x in levels)
          + f" (bound {levels[0]['A_bound_ms']:.3f})")
    return levels


class _BatchIter(xgbt.DataIter):
    """``n`` batches of the rows ``X`` (with labels ``y``), in order."""

    def __init__(self, X, y, n):
        super().__init__()
        self.X, self.y, self.n, self.i = X, y, n, 0

    def reset(self):
        self.i = 0

    def next(self, input_data):
        if self.i >= self.n:
            return 0
        rows = len(self.X) // self.n
        sl = slice(self.i * rows, len(self.X) if self.i == self.n - 1
                   else (self.i + 1) * rows)
        input_data(data=self.X[sl], label=self.y[sl])
        self.i += 1
        return 1


def _page_ms(pg, k: int):
    """Page ``k``'s stages on the card: the disk read (host), the copy of
    its packed bytes to the card, their unpack there, and (for comparison)
    the JAX package's numpy unpack on the host."""
    t0 = time.perf_counter()
    raw = pg._read_raw(k)
    read = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    dev = torch.from_numpy(raw).to(DEVICE)
    torch.cuda.synchronize()
    copy = (time.perf_counter() - t0) * 1e3
    rows = pg.rows_of(k)
    unpack = time_ms(lambda: xext.unpack_symbols_torch(
        dev, pg.bits, rows * pg.n_features, torch.int16))
    t0 = time.perf_counter()
    xext.unpack_symbols(raw, pg.bits, rows * pg.n_features, pg.dtype)
    host_unpack = (time.perf_counter() - t0) * 1e3
    return dict(rows=rows, bytes=int(raw.size), read_ms=read, copy_ms=copy,
                unpack_ms=unpack, host_unpack_ms=host_unpack)


def phase_paged_levels(pg, whole, ytr):
    """Kernel A on every page at every level of the paged matrix's first
    tree (round 0's logistic gradients, the tables of a real grown tree):
    bitwise its plain version, the pages' int64 histograms summing to
    kernel A's histogram of the whole matrix (the streaming matrix's
    bins), and timed per page beside its plain version and one
    ``index_add_`` of the page's float gradients. Returns the per-level
    records and the grown heap state."""
    B = whole.cuts.max_bin
    g = torch.as_tensor(0.5 - ytr, device=DEVICE)
    h = torch.full_like(g, 0.25)
    gq = hk.quantize_gradients(g, h)
    cfg = GrowParams(max_depth=DEPTH)
    st = _init_state(cfg, gq.totals(), B, COLS)
    pos = [torch.zeros((pg.rows_of(k), 1), dtype=torch.int32, device=DEVICE)
           for k in range(pg.n_pages)]
    pos_all = torch.zeros((pg.n_rows, 1), dtype=torch.int32, device=DEVICE)
    levels = []
    for d in range(DEPTH):
        K = 1 << d
        kw = dict(K=K, Kp=K >> 1, B=B, d=d)
        hist, per_page = 0, []
        for k in range(pg.n_pages):
            lo, rows = k * pg.page_rows, pg.rows_of(k)
            bins = pg.device_page(k, DEVICE)
            check(torch.equal(bins, whole.bins[lo:lo + rows]),
                  f"paged levels: page {k} bins == streaming bins")
            bins_t = hk.feature_major(bins)
            sub = hk.QuantizedGradients(q=gq.q[lo:lo + rows], exp=gq.exp)
            p1, h1 = hk._fused_level_cuda(bins, pos[k], sub, st.ptab,
                                          bins_t=bins_t, **kw)
            p2, h2 = hk._fused_level_plain(bins, pos[k], sub, st.ptab, **kw)
            check(torch.equal(p1, p2) and torch.equal(h1, h2),
                  f"paged levels: level {d} page {k}: kernel A == plain")
            ms = time_ms(lambda: hk._fused_level_cuda(
                bins, pos[k], sub, st.ptab, bins_t=bins_t, **kw))
            # the plain version and the library yardstick on this page
            plain_ms = time_ms(lambda: hk._fused_level_plain(
                bins, pos[k], sub, st.ptab, **kw), reps=3, warmup=1)
            lib_ms = _index_add_ms(bins, p1[:, 0].long() - (K - 1),
                                   g[lo:lo + rows], h[lo:lo + rows], K, B,
                                   reps=10)
            b_ms, b_by = level_bounds(rows, COLS, 0, B, 2, d)[1]
            per_page.append(dict(rows=rows, ms=ms, plain_ms=plain_ms,
                                 library_ms=lib_ms, bound_ms=b_ms,
                                 bound_by=b_by))
            pos[k], hist = p1, hist + h1
        pos_all, want = hk._fused_level_cuda(
            whole.bins, pos_all, gq, st.ptab, bins_t=whole.feature_major(),
            **kw)
        check(torch.equal(hist, want),
              f"paged levels: level {d}: page sum == whole-matrix histogram")
        check(torch.equal(torch.cat(pos), pos_all),
              f"paged levels: level {d}: positions")
        st = _level_update(st, gq.dequantize(hist, hk.level_lanes(K, DEVICE)),
                           whole.cut_values, cfg, d)
        levels.append(per_page)
    print("paged levels: kernel A == plain on every page at levels 0-5, "
          "page sums == whole-matrix histograms; ms per page (mean over "
          "levels; plain, index_add_): " + ", ".join(
              f"{_mean([lv[k] for lv in levels], 'ms'):.3f} ("
              f"{_mean([lv[k] for lv in levels], 'plain_ms'):.3f}, "
              f"{_mean([lv[k] for lv in levels], 'library_ms'):.3f})"
              for k in range(pg.n_pages)))
    return levels, st


def phase_external_memory(Xtr, ytr, Xte, yte):
    """The main path paged: the 1M x 50 rows fed by a ``DataIter`` of 8
    batches into an ``ExternalMemoryQuantileDMatrix`` (max_bin 256, pages
    of 262,144 rows: 4 pages, the last 213,568 rows, 9 bits a symbol) in a
    temporary directory; 10 rounds at depth 6 with AUC + logloss on the
    held-out rows. Gates: a ``StreamingQuantileDMatrix`` of the same
    iterator has the same cuts and bins and grows the same trees; kernel A
    240 launches and C, D none on the paged run; AUC >= 0.80 and rising;
    the page-streamed margins within 1e-6 of the cached training margins;
    a 64k-row slice trained paged on the card and the CPU grows the same
    trees; and kernel A on every page at every level of the first tree
    (``phase_paged_levels``)."""
    from xgboost_tpu_torch.data.iterator import StreamingQuantileDMatrix

    out = {}
    with tempfile.TemporaryDirectory(prefix="xgbt_extmem_") as tmp:
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dp = xgbt.ExternalMemoryQuantileDMatrix(
            _BatchIter(Xtr, ytr, EXT_BATCHES),
            cache_prefix=os.path.join(tmp, "cache"),
            max_bin=DEFAULT_MAX_BIN, page_rows=EXT_PAGE_ROWS)
        t_ingest = time.perf_counter() - t0
        pg = dp._paged
        disk = sum(os.path.getsize(pg.page_path(k))
                   for k in range(pg.n_pages))
        check(pg.n_pages == 4 and pg.rows_of(3) == ROWS - 3 * EXT_PAGE_ROWS
              and pg.bits == 9 and pg.packed,
              f"external memory: {pg.n_pages} pages, last "
              f"{pg.rows_of(pg.n_pages - 1)} rows, {pg.bits} bits")
        t0 = time.perf_counter()
        ds = StreamingQuantileDMatrix(_BatchIter(Xtr, ytr, EXT_BATCHES),
                                      max_bin=DEFAULT_MAX_BIN)
        torch.cuda.synchronize()
        t_stream = time.perf_counter() - t0
        whole = ds.get_binned(DEFAULT_MAX_BIN)
        check(np.array_equal(pg.cuts.values, whole.cuts.values)
              and np.array_equal(pg.cuts.min_vals, whole.cuts.min_vals),
              "external memory: paged cuts == streaming cuts")
        for k in range(pg.n_pages):
            lo = k * EXT_PAGE_ROWS
            check(np.array_equal(pg.read_page(k), whole.bins[
                lo:lo + pg.rows_of(k)].cpu().numpy()),
                f"external memory: page {k} == streaming bins")
        pages = [_page_ms(pg, k) for k in range(pg.n_pages)]
        print(f"external memory: ingest {t_ingest:.2f} s (streaming matrix "
              f"{t_stream:.2f} s), {pg.n_pages} pages of {EXT_PAGE_ROWS} "
              f"rows, {pg.bits} bits a bin, {disk} bytes on disk (int16 "
              f"would be {ROWS * COLS * 2}); per page " + "; ".join(
                  f"read {p['read_ms']:.2f} ms, copy {p['copy_ms']:.2f} ms, "
                  f"unpack {p['unpack_ms']:.3f} ms (host "
                  f"{p['host_unpack_ms']:.1f})" for p in pages))
        levels, st = phase_paged_levels(pg, whole, ytr)
        dte = xgbt.DMatrix(Xte, yte)
        runs = {}
        for name, dtrain in (("paged", dp), ("streaming", ds)):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base_gb = torch.cuda.memory_allocated() / 2**30
            io0 = dict(pg.io)
            reset_launches()
            res, probe = {}, _RoundProbe()
            bst = xgbt.train(PARAMS_DEFAULT, dtrain, ROUNDS,
                             evals=[(dte, "test")], evals_result=res,
                             callbacks=[probe], verbose_eval=False)
            got = launches()
            runs[name] = dict(bst=bst, launches=got, auc=res["test"]["auc"],
                              logloss=res["test"]["logloss"],
                              ms_per_round=probe.median_ms(),
                              round_ms=probe.times,
                              device_peak_gb=torch.cuda.max_memory_allocated()
                              / 2**30, device_before_gb=base_gb)
            if name == "paged":
                io = {k: pg.io[k] - io0[k] for k in io0}
                runs[name]["io"] = io
            auc = res["test"]["auc"]
            print(f"external memory ({name}): launches {got}, median round "
                  f"{probe.median_ms():.1f} ms (with eval), auc "
                  f"{auc[0]:.6f} -> {auc[-1]:.6f}, device peak "
                  f"{runs[name]['device_peak_gb']:.3f} GiB (held before: "
                  f"{base_gb:.3f})")
        io = runs["paged"]["io"]
        reads = io["reads"]
        print(f"external memory: paged training read {reads} pages "
              f"({io['prefetched']} prefetched), read {io['read_s']:.3f} s "
              f"in all, waited {io['wait_s']:.3f} s for prefetches")
        want = {"A": ROUNDS * DEPTH * pg.n_pages, "C": 0, "D": 0}
        for k, v in want.items():
            check(runs["paged"]["launches"][k] == v,
                  f"external memory: kernel {k} launched "
                  f"{runs['paged']['launches'][k]} times, want {v}")
        auc = runs["paged"]["auc"]
        check(auc[-1] >= 0.80 and auc[-1] > auc[0],
              f"external memory: held-out AUC {auc}")
        bp, bs = runs["paged"]["bst"], runs["streaming"]["bst"]
        first = heap_trees(bp, 1)[0]  # before save_raw materializes them
        check(bp.save_raw() == bs.save_raw(),
              "external memory: paged trees == streaming trees")
        check(np.array_equal(first["feature"], st.feature.cpu().numpy())
              and np.array_equal(first["split_bin"],
                                 st.split_bin.cpu().numpy()),
              "external memory: the level check's tree == the first tree")
        cached = bp.predict(dp, output_margin=True)
        bp._caches.clear()
        reset_launches()
        t0 = time.perf_counter()
        walked = bp.predict(dp, output_margin=True)
        t_walk = time.perf_counter() - t0
        err = float(np.abs(walked - cached).max())
        check(err <= 1e-6 and predict_margin.launches == pg.n_pages,
              f"external memory: page-streamed margins err {err}, "
              f"{predict_margin.launches} walks")
        print(f"external memory: page-streamed predict of {ROWS} rows "
              f"{t_walk * 1e3:.1f} ms ({pg.n_pages} walks), max abs err "
              f"{err} against the cached training margins")
        out.update(ingest_s=t_ingest, streaming_ingest_s=t_stream,
                   disk_bytes=disk, pages=pages, levels=levels,
                   page_walk_err=err, page_walk_s=t_walk,
                   **{k: {x: v for x, v in r.items() if x != "bst"}
                      for k, r in runs.items()})
        pg.cleanup()
        del dp, ds, whole, runs, bp, bs
        # the 64k-row slice, paged on the card and on the CPU
        trees = []
        for dev in (DEVICE, torch.device("cpu")):
            d = xgbt.ExternalMemoryQuantileDMatrix(
                _BatchIter(Xtr[:CPU_ROWS], ytr[:CPU_ROWS], 2),
                cache_prefix=os.path.join(tmp, f"small_{dev.type}"),
                max_bin=DEFAULT_MAX_BIN, page_rows=EXT_CPU_PAGE_ROWS,
                device=dev)
            bst = xgbt.train(PARAMS_DEFAULT, d, CPU_ROUNDS,
                             verbose_eval=False)
            trees.append(bst.save_raw())
            d._paged.cleanup()
        check(trees[0] == trees[1],
              "external memory: 64k paged card == CPU trees")
        print(f"external memory: {CPU_ROWS} rows in pages of "
              f"{EXT_CPU_PAGE_ROWS}, {CPU_ROUNDS} rounds: card == CPU trees")
    return out


# ---------------------------------------------------------------------------
# phase 40: distributed training over torch.distributed
# ---------------------------------------------------------------------------

DIST_TRAIN_CUT, DIST_EVAL_CUT = 600_000, 60_000
DIST_LABEL = "gloo on one card, staged through the host; not NCCL"


def _dist_levels(mesh, binned, label):
    """One tree's levels over ``mesh`` as ``grow_tree_fused(group=)`` grows
    them (gradients of round 0 at margin 0, the scale and the root totals
    reduced over the ranks), on this rank's own rows: at every level the
    route the synced plan picks (kernel D over the resident one-hot, or
    kernel A over the feature-major bins) is held bit for bit against the
    plain version on the same inputs, before its histogram is
    all-reduced. Returns the route and each level's verdict."""
    from xgboost_tpu_torch import collective

    B, bins = DEFAULT_MAX_BIN, binned.bins
    n, F = bins.shape
    onehot = binned.fused_onehot(mesh)
    bins_t = binned.feature_major() if onehot is None else None
    g = torch.as_tensor(0.5 - label, device=DEVICE)
    gq = hk.quantize_gradients(g, torch.full_like(g, 0.25), mesh)
    cfg = GrowParams(max_depth=DEPTH)
    st = _init_state(cfg, gq.totals(mesh), B, F)
    pos = torch.zeros((n, 1), dtype=torch.int32, device=DEVICE)
    same = []
    for d in range(DEPTH):
        K = 1 << d
        kw = dict(K=K, Kp=K >> 1, B=B, d=d)
        if onehot is not None:
            pk, hq = hk._hoisted_level_cuda(bins, onehot, pos, gq, st.ptab,
                                            **kw)
        else:
            pk, hq = hk._fused_level_cuda(bins, pos, gq, st.ptab,
                                          bins_t=bins_t, **kw)
        pp, hp = hk._fused_level_plain(bins, pos, gq, st.ptab, **kw)
        same.append(bool(torch.equal(pk, pp) and torch.equal(hq, hp)))
        del pp, hp
        pos = pk
        hq = collective.all_reduce(hq, mesh, site="level_check")
        st = _level_update(st, gq.dequantize(hq, hk.level_lanes(K, DEVICE)),
                           binned.cut_values, cfg, d)
    route = "D" if onehot is not None else "A"
    check(all(same), f"distributed rank {mesh.rank}: kernel {route} == "
          f"plain at levels {same} on {n} x {F}")
    return dict(route=route, levels_equal=same, rows=n,
                hoisted=0 if onehot is None else onehot.shape[0] // B)


def _dist_run(name, mesh, d, dv, rounds, out, params=PARAMS_DEFAULT):
    """``rounds`` rounds of ``params`` (the reference-default parameters)
    over ``mesh`` with the held-out shard ``dv`` evaluated: the launches,
    per-round times, the collectives' operations, bytes and (device
    all-reduces, timed) seconds per site and per kind
    (``observability.comms``' deltas) and the model, written under
    ``out``."""
    from xgboost_tpu_torch import collective
    from xgboost_tpu_torch.observability import comms
    from xgboost_tpu_torch.parallel import mesh_context

    def delta(by, was):
        now = comms.snapshot(by)
        return {k: {f: v - was.get(k, {}).get(f, 0.0) for f, v in
                    now[k].items()} for k in now}

    reset_launches()
    collective.timing = True
    before = {by: comms.snapshot(by) for by in ("site", "op")}
    probe, res = _RoundProbe(), {}
    try:
        with mesh_context(mesh):
            bst = xgbt.train(params, d, rounds, evals=[(dv, "test")],
                             evals_result=res, verbose_eval=False,
                             callbacks=[probe])
        torch.cuda.synchronize()
    finally:
        collective.timing = False
    got = launches()
    stats, comms_delta = (delta(by, before[by]) for by in ("site", "op"))
    with mesh_context(mesh):
        dist_auc = bst.eval_values([(dv, "test")])["test"]["auc"]
    local_auc = bst.eval_values([(dv, "test")])["test"]["auc"]
    binned = d.get_binned(DEFAULT_MAX_BIN)
    onehot = binned.fused_onehot(mesh)
    trees = heap_trees(bst, min(rounds, CPU_ROUNDS))
    level_check = (_dist_levels(mesh, binned, d.get_label())
                   if name in ("shared", "construct") else None)
    rec = dict(launches=got, round_ms=probe.times, stats=stats,
               level_check=level_check, comms=comms_delta,
               auc=res["test"]["auc"], logloss=res["test"]["logloss"],
               dist_auc=dist_auc, local_auc=local_auc,
               eval_rows=dv.num_row(), rows=d.num_row(),
               hoisted=0 if onehot is None else onehot.shape[0] //
               DEFAULT_MAX_BIN, cuts=binned.cuts.values.tolist(),
               backend=mesh.backend, world=mesh.world_size)
    with open(os.path.join(out, f"{name}_rank{mesh.rank}.pkl"), "wb") as f:
        pickle.dump(dict(rec, raw=bst.save_raw(), trees=trees), f)


def _dist_rank(rank, world, backend, init_file, out, modes):
    """One rank of phase 40 (started by ``torch.multiprocessing`` with the
    spawn method): the main path's data, this rank's rows, ``modes`` run in
    order."""
    from xgboost_tpu_torch.parallel import init_distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = init_distributed(f"file://{init_file}", world, rank,
                            backend=backend, device="cuda")
    X, y, _ = _make_data(ROWS + EVAL_ROWS, COLS, 0.0, seed=42)
    Xtr, ytr, Xte, yte = X[:ROWS], y[:ROWS], X[ROWS:], y[ROWS:]
    cut = DIST_TRAIN_CUT if world == 2 else ROWS
    ecut = DIST_EVAL_CUT if world == 2 else EVAL_ROWS
    lo, hi = (0, cut) if rank == 0 else (cut, ROWS)
    vlo, vhi = (0, ecut) if rank == 0 else (ecut, EVAL_ROWS)
    dv = xgbt.DMatrix(Xte[vlo:vhi], yte[vlo:vhi])
    dall = xgbt.DMatrix(Xtr, ytr)  # the whole matrix's cuts, as the parent's
    dall.get_binned(DEFAULT_MAX_BIN)

    def shared():
        return xgbt.QuantileDMatrix(Xtr[lo:hi], ytr[lo:hi],
                                    max_bin=DEFAULT_MAX_BIN, ref=dall)

    for mode in modes:
        if mode == "shared":
            _dist_run(mode, mesh, shared(), dv, ROUNDS, out)
        elif mode == "construct":
            os.environ["XGBTPU_HOIST_BUDGET_MB"] = "0"
            _dist_run(mode, mesh, shared(), dv, CPU_ROUNDS, out)
            del os.environ["XGBTPU_HOIST_BUDGET_MB"]
        elif mode == "sketch":
            _dist_run(mode, mesh, xgbt.DMatrix(Xtr[lo:hi], ytr[lo:hi]), dv,
                      ROUNDS, out)
        elif mode == "nccl1":
            _dist_run(mode, mesh, shared(), dv, CPU_ROUNDS, out)
        elif mode == "lossguide":
            _dist_run(mode, mesh, shared(), dv, LG_DIST_ROUNDS, out,
                      params=LG_PARAMS)
        torch.cuda.empty_cache()
    xgbt.collective.finalize()


def _spawn_ranks(world, backend, modes, out):
    """Run phase 40's ranks in child processes (spawn: CUDA is initialised
    here); a rank that raises fails the phase. Returns {mode: [rank
    records]}."""
    import torch.multiprocessing as mp

    init = os.path.join(out, f"pg_{backend}_{world}")
    mp.start_processes(_dist_rank, args=(world, backend, init, out, modes),
                       nprocs=world, join=True, start_method="spawn")
    recs = {}
    for mode in modes:
        recs[mode] = []
        for r in range(world):
            with open(os.path.join(out, f"{mode}_rank{r}.pkl"), "rb") as f:
                recs[mode].append(pickle.load(f))
    return recs


def _dist_summary(name, recs, label):
    """Print and return a distributed run's per-rank numbers: median round,
    the level histograms' all-reduce ms per level, bytes per tree."""
    out = []
    for r, rec in enumerate(recs):
        st = rec["stats"]
        lv = st.get("level_hist", {})
        calls, secs = lv.get("ops", 0), lv.get("seconds", 0.0)
        trees = sum(1 for _ in rec["round_ms"])
        per_tree = sum(st[k]["bytes"] for k in ("level_hist", "root_totals",
                                                "grad_scale") if k in st) \
            / max(trees, 1)
        row = dict(rank=r, rows=rec["rows"], hoisted=rec["hoisted"],
                   level_check=rec["level_check"],
                   median_round_ms=statistics.median(rec["round_ms"]),
                   allreduce_ms_per_level=secs / max(calls, 1) * 1e3,
                   allreduce_levels=calls, bytes_per_tree=per_tree,
                   launches=rec["launches"], backend=rec["backend"])
        print(f"{name} rank {r} ({label}): {rec['rows']} rows, hoisted "
              f"{rec['hoisted']}/{COLS}, launches {rec['launches']}, median "
              f"round {row['median_round_ms']:.1f} ms, histogram all_reduce "
              f"{row['allreduce_ms_per_level']:.3f} ms/level over {calls} "
              f"levels, {per_tree:.0f} bytes reduced per tree")
        out.append(row)
    return out


def phase_distributed(Xtr, ytr, raw256, logloss256, trees256):
    """Phase 40: the main path's training over ``torch.distributed`` ranks
    in child processes, each on its own rows, the level histograms
    all-reduced: (1) world 2 over gloo on one card on ragged shards
    (600k / 400k training, 60k / 40k held-out rows) with shared cuts,
    then by the construct route, then on the distributed sketch; (2) world
    1 over NCCL; (3) world 2 over NCCL where there are two cards."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    out_dir = tempfile.mkdtemp(prefix="xgbt_dist_")
    from xgboost_tpu_torch.observability.comms import grow_psum_bytes

    want_bytes = grow_psum_bytes(DEPTH, COLS, DEFAULT_MAX_BIN)
    # phase 42's single process: 3 lossguide rounds on all the rows
    raw_lg = xgbt.train(LG_PARAMS, xgbt.DMatrix(Xtr, ytr), LG_DIST_ROUNDS,
                        verbose_eval=False).save_raw()
    torch.cuda.empty_cache()
    g2 = _spawn_ranks(2, "gloo", ("shared", "construct", "sketch",
                                  "lossguide"), out_dir)
    sh, co, sk = g2["shared"], g2["construct"], g2["sketch"]
    for r in range(2):
        check(sh[r]["raw"] == raw256,
              f"distributed rank {r}: model bytes == the single process's")
        check(sh[r]["launches"] == {"A": 0, "B": ROUNDS, "C": 1,
                                    "D": ROUNDS * DEPTH},
              f"distributed rank {r}: launches {sh[r]['launches']}")
        check(all(abs(a - b) <= 1e-6 + 1e-12 for a, b in
                  zip(sh[r]["logloss"], logloss256)),
              f"distributed rank {r}: logloss {sh[r]['logloss']} vs "
              f"{logloss256}")
        st = sh[r]["stats"]
        check(st["level_hist"]["ops"] == ROUNDS * DEPTH
              and st["level_hist"]["bytes"] + st["root_totals"]["bytes"]
              + st["grad_scale"]["bytes"] == ROUNDS * want_bytes,
              f"distributed rank {r}: level all-reduces and bytes == "
              f"comms.grow_psum_bytes")
        check(co[r]["launches"] == {"A": CPU_ROUNDS * DEPTH, "B": CPU_ROUNDS,
                                    "C": 0, "D": 0},
              f"distributed construct rank {r}: launches {co[r]['launches']}")
        same_trees(co[r]["trees"], sh[r]["trees"],
                   f"distributed construct rank {r}")
    s, w = 0.0, 0.0
    for rec in sh:
        s += rec["local_auc"] * rec["eval_rows"]
        w += rec["eval_rows"]
    check(sh[0]["dist_auc"] == sh[1]["dist_auc"] == s / w,
          "distributed AUC == the weighted mean of the ranks' own")
    # the distributed sketch: the same cuts on both ranks, the merge of the
    # two shards' summaries
    from xgboost_tpu_torch.data.sketch import local_summary, merge_summaries

    parts = [local_summary(torch.as_tensor(Xtr[lo:hi], device=DEVICE), None,
                           DEFAULT_MAX_BIN)
             for lo, hi in ((0, DIST_TRAIN_CUT), (DIST_TRAIN_CUT, ROWS))]
    merged, _ = merge_summaries(*[torch.stack(p) for p in zip(*parts)],
                                DEFAULT_MAX_BIN)
    merged = merged.cpu().numpy()
    del parts
    check(sk[0]["cuts"] == sk[1]["cuts"], "distributed sketch: ranks' cuts")
    check(np.array_equal(np.asarray(sk[0]["cuts"], np.float32), merged),
          "distributed sketch: cuts == merge of the shards' summaries")
    check(sk[0]["raw"] == sk[1]["raw"], "distributed sketch: ranks' models")
    check(sk[0]["auc"][-1] > sk[0]["auc"][0]
          and abs(sk[0]["auc"][-1] - sh[0]["auc"][-1]) <= 0.01,
          f"distributed sketch AUC {sk[0]['auc']} vs {sh[0]['auc'][-1]}")
    print(f"distributed world 2 ({DIST_LABEL}): models == single process, "
          f"AUC {sh[0]['auc'][0]:.6f} -> {sh[0]['auc'][-1]:.6f} (weighted "
          f"mean of {sh[0]['local_auc']:.6f} / {sh[1]['local_auc']:.6f}); "
          f"distributed sketch AUC -> {sk[0]['auc'][-1]:.6f}; "
          f"{want_bytes} bytes per tree expected")
    rec = dict(label=DIST_LABEL, shared=_dist_summary(
        "distributed", sh, DIST_LABEL),
        construct=_dist_summary("distributed construct", co, DIST_LABEL),
        sketch=_dist_summary("distributed sketch", sk, DIST_LABEL),
        auc=sh[0]["auc"], sketch_auc=sk[0]["auc"],
        dist_auc=sh[0]["dist_auc"],
        local_auc=[r["local_auc"] for r in sh],
        expected_bytes_per_tree=want_bytes)
    n1 = _spawn_ranks(1, "nccl", ("nccl1",), out_dir)["nccl1"][0]
    check(n1["backend"] == "nccl" and n1["world"] == 1, "NCCL world 1")
    same_trees(n1["trees"], trees256, "NCCL world 1 vs single process")
    check(n1["stats"]["level_hist"]["ops"] == CPU_ROUNDS * DEPTH,
          "NCCL world 1: every level all-reduced")
    rec["nccl_world1"] = _dist_summary("distributed NCCL world 1", [n1],
                                       "NCCL, one rank")[0]
    if torch.cuda.device_count() >= 2:
        n2 = _spawn_ranks(2, "nccl", ("shared",), out_dir)["shared"]
        for r in range(2):
            check(n2[r]["raw"] == raw256, f"NCCL world 2 rank {r} model")
        rec["nccl_world2"] = _dist_summary("distributed NCCL world 2", n2,
                                           "NCCL, one card per rank")
    else:
        print(json.dumps({"distributed_nccl_world2": "not run: 1 card"}))
        rec["nccl_world2"] = "not run: 1 card"
    rec["lossguide"] = phase_dist_lossguide(g2["lossguide"], raw_lg)
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"distributed phase: {rec['phase_s']:.1f} s")
    return rec


# ---------------------------------------------------------------------------
# phases 41-43: lossguide under a row group, the rounding repairs, tracing
# ---------------------------------------------------------------------------

LG_DIST_ROUNDS = 3


def _lossguide_sites_per_tree(F=COLS, B=DEFAULT_MAX_BIN):
    """A lossguide tree's device all-reduces over a row group per site,
    as {site: (operations, bytes)}: the gradient scale (float32 [2]), the
    root totals (int64 [2]), and the root's int64 ``[F, 2, B]`` histogram
    with one ``[F, 4 K_EXP, B]`` histogram (its ``2 K_EXP`` children's) a
    step."""
    cell = F * B * 8
    hist = 2 * cell + LG_STEPS * 4 * glg.expansions_per_step(LG_LEAVES) * cell
    return {"grad_scale": (1, 8), "root_totals": (1, 16),
            "lossguide_hist": (1 + LG_STEPS, hist)}


def phase_dist_lossguide(lg, raw_lg):
    """Phase 42 (its ranks ran in phase 40's spawn): lossguide at
    LightGBM's 255 leaves over world 2 (gloo, one card, 600k / 400k rows,
    shared cuts), 3 rounds: both ranks' model bytes equal the single
    process's; kernel A on each rank 1 + 35 times a tree (every step's
    child histograms on the rank's own rows), B once a round, C and D
    never; ``observability.comms``' record of the run, per site, equal to
    every step's all-reduce (``_lossguide_sites_per_tree``), and per kind
    the sum of its sites. Printed per rank: the launches, the median round
    and the child histograms' all-reduce ms per step (host clock between
    device synchronizations, the slower rank's wait included)."""
    want = {"A": LG_DIST_ROUNDS * (1 + LG_STEPS), "B": LG_DIST_ROUNDS,
            "C": 0, "D": 0}
    per_tree = _lossguide_sites_per_tree()
    want_bytes = sum(b for _, b in per_tree.values())
    out = []
    for r, rec in enumerate(lg):
        check(rec["raw"] == raw_lg,
              f"distributed lossguide rank {r}: model bytes == the single "
              f"process's")
        check(rec["launches"] == want,
              f"distributed lossguide rank {r}: launches {rec['launches']}, "
              f"want {want}")
        st = rec["stats"]
        check(all(st[k]["ops"] == LG_DIST_ROUNDS * n
                  and st[k]["bytes"] == LG_DIST_ROUNDS * b
                  for k, (n, b) in per_tree.items()),
              f"distributed lossguide rank {r}: all-reduces per site {st}")
        c = rec["comms"]
        check(c["pmax"]["bytes"] == st["grad_scale"]["bytes"]
              and c["psum_hist"]["bytes"] == st["root_totals"]["bytes"]
              + st["lossguide_hist"]["bytes"]
              and c["psum_hist"]["ops"] == LG_DIST_ROUNDS * (2 + LG_STEPS),
              f"distributed lossguide rank {r}: comms {c}")
        calls = st["lossguide_hist"]["ops"]
        secs = st["lossguide_hist"]["seconds"]
        row = dict(rank=r, rows=rec["rows"], launches=rec["launches"],
                   A_per_tree=rec["launches"]["A"] / LG_DIST_ROUNDS,
                   median_round_ms=statistics.median(rec["round_ms"]),
                   round_ms=rec["round_ms"],
                   allreduce_ms_per_step=secs / max(calls, 1) * 1e3,
                   allreduce_steps=calls, bytes_per_tree=want_bytes,
                   auc=rec["auc"], comms=c)
        print(f"distributed lossguide rank {r} ({DIST_LABEL}): "
              f"{rec['rows']} rows, {LG_LEAVES} leaves, launches "
              f"{rec['launches']} (A {row['A_per_tree']:.0f} a tree), median "
              f"round {row['median_round_ms']:.1f} ms, child histogram "
              f"all_reduce {row['allreduce_ms_per_step']:.3f} ms/step over "
              f"{calls:.0f} steps, {want_bytes} bytes a tree, auc "
              f"{rec['auc']}")
        out.append(row)
    return out


def _node_totals_case(Xtr):
    """The local histmaker's node totals (``grow_local._segment_totals``)
    at the main path's width: hessian-like weights of the 1M training rows
    in each of the 50 features' value order, as one node (level 0) and as
    32 (level 5, split at random sorted positions): the card's totals equal
    the CPU's bit for bit; ms on the card (CUDA events)."""
    from xgboost_tpu_torch.tree.grow_local import _segment_totals

    rng = np.random.RandomState(11)
    p = 1.0 / (1.0 + np.exp(-rng.randn(ROWS)))
    hw = torch.as_tensor((p * (1.0 - p)).astype(np.float32), device=DEVICE)
    order = torch.argsort(torch.as_tensor(Xtr, device=DEVICE).t(), dim=1,
                          stable=True)
    w_s = hw[order].contiguous()  # [F, n]
    del order
    out = {}
    for K in (1, 32):
        b = np.sort(rng.randint(0, ROWS, (COLS, K + 1)), axis=1)
        b[:, 0], b[:, -1] = 0, ROWS
        lo, hi = (torch.as_tensor(x, device=DEVICE) for x in (b[:, :-1],
                                                             b[:, 1:]))
        card = _segment_totals(w_s, lo, hi).cpu()
        cpu = _segment_totals(w_s.cpu(), lo.cpu(), hi.cpu())
        check(torch.equal(card, cpu),
              f"node totals {COLS} x {ROWS}, {K} nodes: card == CPU bitwise")
        ms = time_ms(lambda: _segment_totals(w_s, lo, hi), reps=5, warmup=1)
        out[f"nodes_{K}"] = dict(ms=ms, rows=ROWS, features=COLS)
        print(f"local histmaker node totals ({COLS} x {ROWS}, {K} nodes): "
              f"card == CPU bitwise, {ms:.3f} ms on the card")
    return out


def phase_rounding(Xtr, ytr, Xte):
    """Phase 41: the two rounding repairs on the card. ``compute_cuts`` at
    max_bin 100 and 1000 on 999,963 of the main path's rows (10 of its
    features, to keep the CPU's sort short) with unit weights, and on 64k
    rows with hessian-like weights ``p (1 - p)``: the card's cuts equal the
    CPU's bit for bit (the levels' explicit reciprocal). The local
    histmaker's node totals at the main path's width (``_node_totals_case``).
    Then the local histmaker at max_bin 100 for 3 rounds on 64k rows, card
    against CPU: the same trees (float32 node totals in row order,
    ``_cdf`` prefix sums, fused targets), kernel A 6 times a tree on the
    card."""
    from xgboost_tpu_torch.data.quantile import compute_cuts

    t_phase = time.perf_counter()
    out = {}
    rng = np.random.RandomState(7)
    p = 1.0 / (1.0 + np.exp(-rng.randn(CPU_ROWS)))
    hw = (p * (1.0 - p)).astype(np.float32)
    cases = [("unit", Xtr[:ROWS - 37, :10], None),
             ("hessian", Xtr[:CPU_ROWS], hw)]
    for kind, X, w in cases:
        for B in (100, 1000):
            got = []
            for dev in (DEVICE, torch.device("cpu")):
                Xd = torch.as_tensor(X, device=dev)
                wd = None if w is None else torch.as_tensor(w, device=dev)
                t0 = time.perf_counter()
                c = compute_cuts(Xd, B, wd)
                got.append((c, time.perf_counter() - t0))
                del Xd
            (card, card_s), (cpu, cpu_s) = got
            same = (np.array_equal(card.values, cpu.values)
                    and np.array_equal(card.min_vals, cpu.min_vals))
            check(same, f"cuts {kind} max_bin {B}: card == CPU bitwise")
            out[f"cuts_{kind}_{B}"] = dict(rows=X.shape[0],
                                           features=X.shape[1],
                                           card_s=card_s, cpu_s=cpu_s)
            print(f"cuts ({kind} weights, {X.shape[0]} x {X.shape[1]}, "
                  f"max_bin {B}): card == CPU bitwise (card {card_s:.3f} "
                  f"s, CPU {cpu_s:.3f} s)")
    out["node_totals"] = _node_totals_case(Xtr)
    reset_launches()
    params = {**LOCAL_PARAMS, "max_bin": 100}
    out["local_100_card_vs_cpu"] = phase_card_vs_cpu(
        Xtr, ytr, Xte, name="local histmaker max_bin 100 card vs CPU",
        params=params)
    got = launches()
    check(got["A"] == CPU_ROUNDS * DEPTH and got["C"] == got["D"] == 0,
          f"local histmaker max_bin 100: launches {got}")
    out["local_100_launches"] = got
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"rounding repairs: launches {got}; {out['phase_s']:.1f} s")
    return out


class _LaunchProbe(_RoundProbe):
    """``_RoundProbe``'s round times and each round's kernel launches."""

    def __init__(self):
        super().__init__()
        self.per_round, self._l0 = [], None

    def before_iteration(self, model, epoch, evals_log):
        stop = super().before_iteration(model, epoch, evals_log)
        self._l0 = launches()
        return stop

    def after_iteration(self, model, epoch, evals_log):
        stop = super().after_iteration(model, epoch, evals_log)
        now = launches()
        self.per_round.append({k: now[k] - self._l0[k] for k in now})
        return stop


TRACE_PAIRS = 40


class _TraceToggle(xgbt.callback.TrainingCallback):
    """Turns tracing on or off before each round (after a device
    synchronize, outside the timed period): on is the span trace and the
    flight recorder's files in ``run_dir`` (``flight.configure``), off is
    neither (the recorder's in-memory ring, as untraced runs keep it).
    Times every round from its start to the next round's start, so the
    recorder's end-of-round writes fall in the round that made them."""

    def __init__(self, traced, run_dir):
        self.traced, self.run_dir = traced, run_dir
        self.period_ms, self._t0 = [], None

    def _mark(self):
        torch.cuda.synchronize()
        now = time.perf_counter()
        if self._t0 is not None:
            self.period_ms.append((now - self._t0) * 1e3)
        return now

    def before_iteration(self, model, epoch, evals_log):
        from xgboost_tpu_torch.observability import RECORDER, flight

        self._mark()
        RECORDER.reset()
        if self.traced[epoch]:
            flight.configure(self.run_dir, rank=0)
        torch.cuda.synchronize()
        self._t0 = time.perf_counter()
        return False

    def after_training(self, model):
        self._mark()
        return model


def _host_cost_us(fn, n):
    t0 = time.perf_counter_ns()
    for _ in range(n):
        fn()
    return (time.perf_counter_ns() - t0) / n / 1e3


def _trace_cost(Xtr, ytr, Xte, yte, spans_per_round):
    """Tracing's cost a round, two ways. (1) Paired rounds: 2 warm-up
    rounds, then ``TRACE_PAIRS`` pairs of adjacent rounds of one training
    run (the main path at max_bin 256, held-out eval), one traced and one
    not, the traced one first in every other pair; the median of the
    paired differences (traced minus untraced) with its quartiles. (2)
    Counted: the spans a round (from the traced runs' trace) times a
    span's host cost on and off, plus a round record's cost with the
    recorder's files on and off, each timed over many calls."""
    from xgboost_tpu_torch.observability import RECORDER, flight, trace

    tmp = tempfile.mkdtemp(prefix="xgbt_trace_pairs_")
    traced = [False, False]
    for j in range(TRACE_PAIRS):
        traced += [j % 2 == 1, j % 2 == 0]
    toggle = _TraceToggle(traced, tmp)
    dtrain, dtest = xgbt.DMatrix(Xtr, ytr), xgbt.DMatrix(Xte, yte)
    bst = xgbt.train(PARAMS_DEFAULT, dtrain, len(traced),
                     evals=[(dtest, "test")], verbose_eval=False,
                     callbacks=[toggle])
    RECORDER.reset()
    trace.reset()
    per = toggle.period_ms
    check(len(per) == len(traced), f"trace pairs: {len(per)} periods")
    diffs = []
    for j in range(TRACE_PAIRS):
        a, b = 2 + 2 * j, 3 + 2 * j
        on, off = (a, b) if traced[a] else (b, a)
        diffs.append(per[on] - per[off])
    q = statistics.quantiles(diffs, n=4)
    del bst, dtrain, dtest
    torch.cuda.empty_cache()

    def empty_span():
        with trace.span("cost", i=1):
            pass

    n = 20_000
    span_off = _host_cost_us(empty_span, n)
    trace.set_sink(os.path.join(tmp, "cost.jsonl"))
    span_on = _host_cost_us(empty_span, n)
    trace.reset()
    trace.set_sink(None)

    def round_record():
        RECORDER.begin_round(0)
        flight.note("grow", 0.1)
        RECORDER.end_round()

    rec_off = _host_cost_us(round_record, 200)
    flight.configure(tmp, rank=0)
    rec_on = _host_cost_us(round_record, 200)
    RECORDER.reset()
    trace.reset()
    counted_ms = (spans_per_round * (span_on - span_off)
                  + rec_on - rec_off) / 1e3
    out = dict(pairs=TRACE_PAIRS, diffs_ms=diffs,
               median_diff_ms=statistics.median(diffs),
               q1_ms=q[0], q3_ms=q[2], mean_diff_ms=statistics.fmean(diffs),
               stdev_diff_ms=statistics.stdev(diffs),
               median_round_ms_traced=statistics.median(
                   [p for p, t in zip(per[2:], traced[2:]) if t]),
               median_round_ms_untraced=statistics.median(
                   [p for p, t in zip(per[2:], traced[2:]) if not t]),
               spans_per_round=spans_per_round, span_us_on=span_on,
               span_us_off=span_off, record_us_on=rec_on,
               record_us_off=rec_off, counted_ms_per_round=counted_ms)
    print(f"tracing's cost a round (max_bin {DEFAULT_MAX_BIN}, "
          f"{TRACE_PAIRS} pairs of rounds): median traced - untraced "
          f"{out['median_diff_ms']:.3f} ms (quartiles {q[0]:.3f} / "
          f"{q[2]:.3f}, mean {out['mean_diff_ms']:.3f} +- "
          f"{out['stdev_diff_ms']:.3f}); median round traced "
          f"{out['median_round_ms_traced']:.2f}, untraced "
          f"{out['median_round_ms_untraced']:.2f} ms")
    print(f"tracing's cost a round, counted: {spans_per_round:.1f} spans x "
          f"({span_on:.3f} - {span_off:.3f}) us + a record {rec_on:.1f} - "
          f"{rec_off:.1f} us = {counted_ms:.4f} ms")
    return out


def phase_traced(Xtr, ytr, Xte, yte):
    """Phase 43: the reference-default main path (max_bin 256, 10 rounds,
    held-out AUC and logloss) four times in turn, untraced, traced,
    untraced, traced; each traced run records the span trace and the
    flight recorder into a temporary directory
    (``flight.configure``: ``obs/rank0/{trace.jsonl, flight.jsonl,
    metrics.json, clock.json}``). The trees of every run are the first
    run's bit for bit, and so are the kernel launches of every round
    (C 1 in round 0, D 6 and B 1 every round, A never); the trace loads
    back with the JAX package's span names (``train`` > ``round`` >
    ``update`` > ``GetGradient`` / ``GetBinned`` > ``dmatrix_build`` >
    ``sketch`` / ``quantize`` / ``BoostOneRound`` > ``build_tree`` >
    ``grow_tree``, ``eval``), 10 round records with ``grow`` and ``eval``
    stages and the card's allocator peak. Printed: the span names and
    counts, the median round traced and untraced, the last round's record;
    then tracing's cost a round (``_trace_cost``)."""
    from xgboost_tpu_torch.observability import RECORDER, flight, trace

    t_phase = time.perf_counter()
    runs = []
    for traced in (False, True, False, True):
        tmp = tempfile.mkdtemp(prefix="xgbt_trace_") if traced else None
        RECORDER.reset()
        trace.reset()
        if traced:
            flight.configure(tmp, rank=0)
        dtrain, dtest = xgbt.DMatrix(Xtr, ytr), xgbt.DMatrix(Xte, yte)
        torch.cuda.synchronize()
        probe = _LaunchProbe()
        reset_launches()
        bst = xgbt.train(PARAMS_DEFAULT, dtrain, ROUNDS,
                         evals=[(dtest, "test")], verbose_eval=False,
                         callbacks=[probe])
        torch.cuda.synchronize()
        rec = dict(traced=traced, launches=launches(),
                   per_round=probe.per_round, round_ms=probe.times,
                   median_ms=probe.median_ms(),
                   trees=heap_trees(bst, ROUNDS))
        if traced:
            trace.flush()
            d = os.path.join(tmp, "obs", "rank0")
            rec["events"] = [e for e in trace.load_trace(
                os.path.join(d, "trace.jsonl")) if e.get("ph") == "X"]
            with open(os.path.join(d, "flight.jsonl")) as f:
                rec["flight"] = [json.loads(ln) for ln in f]
            rec["files"] = sorted(os.listdir(d))
        RECORDER.reset()
        trace.reset()
        runs.append(rec)
        del bst, dtrain, dtest
        torch.cuda.empty_cache()
    first = runs[0]
    check(first["per_round"][0] == {"A": 0, "B": 1, "C": 1, "D": DEPTH}
          and all(r == {"A": 0, "B": 1, "C": 0, "D": DEPTH}
                  for r in first["per_round"][1:]),
          f"traced phase: untraced launches a round {first['per_round']}")
    for k, r in enumerate(runs[1:], 1):
        same_trees(r["trees"], first["trees"], f"traced phase run {k}")
        check(r["per_round"] == first["per_round"],
              f"traced phase run {k}: launches a round {r['per_round']}")
    names = {}
    for e in runs[1]["events"]:
        names[e["name"]] = names.get(e["name"], 0) + 1
    want = {"train": 1, "round": ROUNDS, "update": ROUNDS,
            "GetGradient": ROUNDS, "GetBinned": ROUNDS, "dmatrix_build": 1,
            "sketch": 1, "quantize": 1, "BoostOneRound": ROUNDS,
            "build_tree": ROUNDS, "grow_tree": ROUNDS, "eval": ROUNDS}
    check(all(names.get(k) == v for k, v in want.items()),
          f"traced phase: span counts {names}")
    rounds = [r for r in runs[1]["flight"] if r["t"] == "round"]
    check(runs[1]["flight"][0]["t"] == "meta" and len(rounds) == ROUNDS
          and all({"grow", "eval"} <= set(r["stages"]) for r in rounds)
          and all(r.get("dev_peak_mb", 0) > 0 for r in rounds),
          "traced phase: flight records")
    check({"trace.jsonl", "flight.jsonl", "metrics.json", "clock.json"}
          <= set(runs[1]["files"]), f"traced phase: files {runs[1]['files']}")
    on = [r["median_ms"] for r in runs if r["traced"]]
    off = [r["median_ms"] for r in runs if not r["traced"]]
    out = dict(span_counts=names, median_ms_traced=on,
               median_ms_untraced=off,
               round_ms={("traced" if r["traced"] else "untraced") + str(i):
                         r["round_ms"] for i, r in enumerate(runs)},
               launches_per_round=first["per_round"],
               launches=first["launches"], last_record=rounds[-1],
               files=runs[1]["files"])
    out["cost"] = _trace_cost(Xtr, ytr, Xte, yte,
                              len(runs[1]["events"]) / ROUNDS)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"traced main path (max_bin {DEFAULT_MAX_BIN}, {ROUNDS} rounds): "
          f"spans {names}")
    print(f"traced main path: median round traced {on} ms, untraced {off} "
          f"ms (whole runs); launches a "
          f"round identical {first['per_round'][:2]}...; trees identical")
    print("traced main path: last flight record " + json.dumps(rounds[-1]))
    print(f"traced main path: {out['phase_s']:.1f} s")
    return out



# Phase 44: crash-safe checkpoints and the resilience layer on the main path
RES_ROUNDS = 12
RES_PARAMS = {**PARAMS_DEFAULT, "max_depth": DEPTH}
RES_KILL_EPOCH = 5      # SIGKILL after round index 5's after_iteration
RES_PALLAS_HIT = 9      # hit 1 the hoist plan, then one eval walk a round
RES_WATCHDOG_FROM = 6   # the round_dispatch deadline armed from round 6
RES_WATCHDOG_S = 0.002  # far below one round's update (~70-150 ms)


class _Killer(xgbt.callback.TrainingCallback):
    """SIGKILLs this process after round ``epoch``'s ``after_iteration``:
    user callbacks run before the checkpoint's, so that round is never
    committed (the JAX package's ``tests/test_crash_resume.py`` Killer)."""

    def __init__(self, epoch):
        self.epoch = epoch

    def after_iteration(self, model, epoch, evals_log):
        if epoch == self.epoch:
            os.kill(os.getpid(), signal.SIGKILL)
        return False


class _ArmWatchdog(xgbt.callback.TrainingCallback):
    """Sets the ``round_dispatch`` deadline from round ``epoch`` on (the
    watchdog reads ``XGBTPU_WATCHDOG`` as each round's update starts)."""

    def __init__(self, epoch, seconds):
        self.epoch, self.seconds = epoch, seconds

    def before_iteration(self, model, epoch, evals_log):
        if epoch == self.epoch:
            os.environ["XGBTPU_WATCHDOG"] = f"round_dispatch={self.seconds}"
        return False


class _ResumeClock:
    """Host clocks (device synchronised) around the three steps of a
    resume inside ``train``: ``checkpoint.load_latest`` (the file read and
    its sha256 check), ``Booster.load_model`` (the JSON parse) and
    ``Booster._fill_caches_by_round`` (the fill walks, kernel B); and,
    without a device synchronisation (the runs without checkpoints have
    none there either), every checkpoint (``_AtomicCheckpoint._save``: the
    trees' copy off the card, the JSON, sha256, write and fsync). Patches
    the four for the block's duration."""

    def __enter__(self):
        from xgboost_tpu_torch import training as tr
        from xgboost_tpu_torch.resilience import checkpoint as ck

        self.ms = {"load_verify": [], "parse": [], "fill": [], "save": []}
        self._undo = []
        for owner, name, key, sync in (
                (ck, "load_latest", "load_verify", True),
                (xgbt.Booster, "load_model", "parse", True),
                (xgbt.Booster, "_fill_caches_by_round", "fill", True),
                (tr._AtomicCheckpoint, "_save", "save", False)):
            orig = getattr(owner, name)
            setattr(owner, name, self._timed(orig, key, sync))
            self._undo.append((owner, name, orig))
        return self

    def _timed(self, fn, key, sync):
        def run(*args, **kwargs):
            if sync:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            if sync:
                torch.cuda.synchronize()
            self.ms[key].append((time.perf_counter() - t0) * 1e3)
            return out
        return run

    def __exit__(self, *exc):
        for owner, name, orig in self._undo:
            setattr(owner, name, orig)
        return False


def _res_train(d, dv, ckdir, callbacks=()):
    """One 12-round run of phase 44 (``resume_from=ckdir`` when given,
    one checkpoint a round): ``(booster, launches, flight round records,
    resume clocks, held-out AUC a trained round)``; the flight recorder is
    reset first."""
    from xgboost_tpu_torch.observability import RECORDER

    RECORDER.reset()
    kw = {} if ckdir is None else dict(resume_from=ckdir,
                                       checkpoint_interval=1)
    hist = {}
    torch.cuda.synchronize()
    reset_launches()
    with _ResumeClock() as clock:
        bst = xgbt.train(RES_PARAMS, d, RES_ROUNDS, evals=[(dv, "eval")],
                         evals_result=hist, verbose_eval=False,
                         callbacks=list(callbacks), **kw)
    torch.cuda.synchronize()
    recs = [r for r in RECORDER.records() if r.get("t") == "round"]
    return bst, launches(), recs, clock.ms, hist["eval"]["auc"]


def _resilience_worker(args) -> int:
    """One process of phase 44: the main-path data from ``args["data"]``,
    a 12-round run with ``resume_from=args["ckpt"]`` (killed after round
    ``args["kill"]`` when given; ``XGBTPU_CHAOS`` from the parent), its
    model bytes, launches, round records and resume clocks pickled to
    ``args["out"]``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    arr = {k: np.load(os.path.join(args["data"], f"{k}.npy"))
           for k in ("Xtr", "ytr", "Xte", "yte")}
    d = xgbt.DMatrix(arr["Xtr"], arr["ytr"])
    dv = xgbt.DMatrix(arr["Xte"], arr["yte"])
    cbs = [] if args.get("kill") is None else [_Killer(args["kill"])]
    start = xgbt.resilience.checkpoint.load_latest(args["ckpt"])
    bst, got, recs, ms, _ = _res_train(d, dv, args["ckpt"], cbs)
    with open(args["out"], "wb") as f:
        pickle.dump(dict(raw=bst.save_raw(), launches=got, records=recs,
                         clocks=ms, start=start[1] if start else 0), f)
    return 0


def _res_spawn(args, env=None):
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--resilience-worker",
         json.dumps(args)], cwd=os.path.dirname(os.path.abspath(__file__)),
        env=dict(os.environ, **(env or {})), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def _res_wait(procs, timeout=300):
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:  # stop every process this phase started
            if p.poll() is None:
                p.kill()
                p.wait()
    return [(p.returncode, o) for p, o in zip(procs, outs)]


def _median_wall(recs):
    return statistics.median(r["wall_s"] * 1e3 for r in recs)


def _ckpt_faults():
    """``faults_total`` at the ``checkpoint_write`` site, every kind."""
    from xgboost_tpu_torch.observability import REGISTRY

    fam = REGISTRY.get("faults_total")
    return sum(c.value for lab, c in fam.series()
               if lab.get("site") == "checkpoint_write") if fam else 0.0


def phase_resilience(Xtr, ytr, Xte, yte):
    """Phase 44: crash-safe checkpoints and the resilience layer on the
    reference-default main path (1M x 50 and 100k held out, max_bin 256,
    depth 6, eta 0.1, AUC + logloss, 12 rounds, one checkpoint a round).
    (a) A straight run with ``resume_from`` a fresh directory: its bytes
    S. (b) A worker process SIGKILLed after round 5's ``after_iteration``
    (exit -9, the newest verified checkpoint 4 or 5 rounds) and the same
    command again: S; the resumed process's launches printed (C 1, D 6 a
    trained round, B an eval walk a trained round plus a fill walk a
    checkpointed round for each of the two caches). (c) Chaos:
    ``checkpoint_write:transient:1`` under ``XGBTPU_RETRY`` absorbed, with
    ``faults_total`` in the exposition, S; ``pallas:permanent:9`` (kernel
    B's wrapper, round 8's eval walk) raises out of ``train`` in a worker
    with a nonzero exit, its abort commit holding 8 rounds, and a rerun
    gives S. (d) A ``round_dispatch`` deadline of 2 ms from round 6 on
    raises ``WatchdogTimeout``, the abort commit holds the rounds before
    it, and an in-process resume gives S. (e) Costs, from eight more runs
    in turns (without ``resume_from``, with a checkpoint a round, with,
    without, and again; each grows S; the chaos of (c) on the first run
    with checkpoints): the checkpoint's ms a round, the payload bytes,
    the resume's load + verify, parse and fill ms, and the median round of
    each run (flight records' wall time). Workers (b, c) run two at a time; the in-process
    timings run alone after them."""
    from xgboost_tpu_torch.observability import REGISTRY
    from xgboost_tpu_torch.resilience import chaos, checkpoint
    from xgboost_tpu_torch.resilience.watchdog import WatchdogTimeout

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="xgbt_resilience_")
    for k, v in (("Xtr", Xtr), ("ytr", ytr), ("Xte", Xte), ("yte", yte)):
        np.save(os.path.join(tmp, f"{k}.npy"), v)
    ck = {k: os.path.join(tmp, f"ck_{k}") for k in ("a", "b", "c", "d")}

    def work(tag, ckdir, kill=None):
        return dict(data=tmp, ckpt=ckdir, kill=kill,
                    out=os.path.join(tmp, f"{tag}.pkl"))

    def result(tag):
        with open(os.path.join(tmp, f"{tag}.pkl"), "rb") as f:
            return pickle.load(f)

    # (b) and (c): the killed run and the chaos abort side by side
    t0 = time.perf_counter()
    killed, aborted = _res_wait([
        _res_spawn(work("killed", ck["b"], RES_KILL_EPOCH)),
        _res_spawn(work("aborted", ck["c"]),
                   {"XGBTPU_CHAOS": f"pallas:permanent:{RES_PALLAS_HIT}"})])
    check(killed[0] == -9, f"resilience: killed worker exit {killed[0]}: "
          f"{killed[1][-2000:]}")
    check(aborted[0] not in (0, -9) and "ChaosPermanent" in aborted[1],
          f"resilience: chaos worker exit {aborted[0]}: {aborted[1][-2000:]}")
    at_kill = checkpoint.load_latest(ck["b"])[1]
    at_abort = checkpoint.load_latest(ck["c"])[1]
    check(at_kill in (RES_KILL_EPOCH - 1, RES_KILL_EPOCH),
          f"resilience: newest checkpoint after the kill {at_kill}")
    check(at_abort == RES_PALLAS_HIT - 1,
          f"resilience: the chaos abort committed {at_abort} rounds")
    for rc, out in _res_wait([_res_spawn(work("resumed", ck["b"])),
                              _res_spawn(work("rerun", ck["c"]))]):
        check(rc == 0, f"resilience: resumed worker exit {rc}: {out[-3000:]}")
    workers_s = time.perf_counter() - t0
    resumed, rerun = result("resumed"), result("rerun")

    # (a), then the costs: runs without resume_from and with a checkpoint a
    # round (the first under checkpoint_write chaos), in turns
    d, dv = xgbt.DMatrix(Xtr, ytr), xgbt.DMatrix(Xte, yte)
    bst, straight_l, recs_a, ms_a, auc = _res_train(d, dv, ck["a"])
    S = bst.save_raw()
    check(auc[-1] >= 0.80 and auc[-1] > auc[0],
          f"resilience: held-out AUC {auc}")
    del bst
    turns = ("none", "ckpt", "ckpt", "none") * 2
    round_ms = {m: [] for m in turns}
    save_ms, stage_ms = [], []
    before = _ckpt_faults()
    os.environ["XGBTPU_RETRY"] = "checkpoint_write=3"
    try:
        for i, mode in enumerate(turns):
            ckdir = None if mode == "none" else os.path.join(tmp, f"ck_e{i}")
            with (chaos.configure("checkpoint_write:transient:1")
                  if i == 1 else contextlib.nullcontext()) as plan:
                bst, _, recs, ms, _ = _res_train(d, dv, ckdir)
            check(bst.save_raw() == S and (ckdir is None or checkpoint
                  .load_latest(ckdir) == (S, RES_ROUNDS)),
                  f"resilience: run {i} ({mode}) grows S")
            del bst
            round_ms[mode].append(_median_wall(recs))
            if mode != "none":
                save_ms.append(statistics.median(ms["save"]))
                stage_ms.append(statistics.median(
                    r["stages"].get("checkpoint", 0.0) * 1e3 for r in recs))
            if i == 1:
                faults = _ckpt_faults() - before
                shown = [ln for ln in REGISTRY.exposition().splitlines()
                         if ln.startswith("faults_total{")
                         and 'site="checkpoint_write"' in ln]
                check(plan.fired == [("checkpoint_write", 1, "transient")]
                      and faults == 1 and shown,
                      f"resilience: checkpoint_write chaos absorbed "
                      f"({plan.fired}, faults {faults}, exposition {shown})")
    finally:
        del os.environ["XGBTPU_RETRY"]

    # (d) the watchdog, then the resume in this process
    try:
        _res_train(d, dv, ck["d"], [_ArmWatchdog(RES_WATCHDOG_FROM,
                                                 RES_WATCHDOG_S)])
        check(False, "resilience: the round_dispatch deadline never fired")
    except WatchdogTimeout as e:
        check(e.site == "round_dispatch", f"resilience: watchdog {e}")
    finally:
        del os.environ["XGBTPU_WATCHDOG"]
    at_watchdog = checkpoint.load_latest(ck["d"])[1]
    check(at_watchdog >= RES_WATCHDOG_FROM,
          f"resilience: the watchdog abort committed {at_watchdog} rounds")
    bst, resumed_here, _, ms_d, _ = _res_train(d, dv, ck["d"])
    check(bst.save_raw() == S, "resilience: resumed after the watchdog: S")
    del bst, d, dv
    torch.cuda.empty_cache()

    check(resumed["raw"] == S, "resilience: killed and resumed == straight")
    check(rerun["raw"] == S, "resilience: chaos abort and rerun == straight")
    trained = RES_ROUNDS - resumed["start"]
    want = {"A": 0, "C": 1, "D": DEPTH * trained,
            "B": trained + 2 * resumed["start"]}
    check(resumed["launches"] == want,
          f"resilience: resumed process launches {resumed['launches']}, "
          f"want {want}")
    check(straight_l == {"A": 0, "B": RES_ROUNDS, "C": 1,
                         "D": DEPTH * RES_ROUNDS},
          f"resilience: straight run launches {straight_l}")
    t0 = time.perf_counter()
    digest = hashlib.sha256(S).hexdigest()
    sha_ms = (time.perf_counter() - t0) * 1e3
    shutil.rmtree(tmp, ignore_errors=True)

    out = dict(
        payload_bytes=len(S), sha256=digest, auc=auc,
        launches_straight=straight_l, launches_resumed=resumed["launches"],
        launches_rerun=rerun["launches"], launches_resumed_here=resumed_here,
        resumed_from=resumed["start"], rerun_from=rerun["start"],
        at_kill=at_kill, at_abort=at_abort, at_watchdog=at_watchdog,
        median_round_ms=dict(straight=_median_wall(recs_a), **round_ms),
        checkpoint_ms=dict(save=save_ms, write_stage=stage_ms),
        resume_ms=dict(load_verify=ms_d["load_verify"],
                       sha256=sha_ms, parse=ms_d["parse"], fill=ms_d["fill"],
                       worker_load_verify=resumed["clocks"]["load_verify"],
                       worker_parse=resumed["clocks"]["parse"],
                       worker_fill=resumed["clocks"]["fill"]),
        workers_s=workers_s)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"resilience: killed after round {RES_KILL_EPOCH} (exit -9, newest "
          f"checkpoint {at_kill} rounds), resumed in a new process: bytes == "
          f"straight ({len(S)} bytes); resumed launches {resumed['launches']}"
          f" (straight {straight_l})")
    print(f"resilience: chaos pallas hit {RES_PALLAS_HIT} raised (exit "
          f"{aborted[0]}), committed {at_abort} rounds, rerun == straight; "
          f"checkpoint_write chaos absorbed; watchdog at round "
          f"{RES_WATCHDOG_FROM} committed {at_watchdog}, resumed == straight")
    print("resilience: costs " + json.dumps(
        {k: out[k] for k in ("median_round_ms", "checkpoint_ms",
                             "resume_ms", "payload_bytes")}))
    print(f"resilience: workers {workers_s:.1f} s, phase "
          f"{out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 45: elastic training; phase 46: the command line
# ---------------------------------------------------------------------------

ELASTIC_ROUNDS = 10
ELASTIC_PARAMS = {**PARAMS_DEFAULT, "max_depth": DEPTH}
ELASTIC_KILL_HIT = 5    # the killed rank dies at its 5th round boundary
ELASTIC_HEARTBEAT = "0.25"
CLI_ROWS, CLI_TEST_ROWS = 100_000, 50_000


def _elastic_block(n: int, r: int, world: int):
    """Rank ``r``'s contiguous block of ``n`` rows in order, the larger
    blocks first (333,334 / 333,333 / 333,333 of 1M at world 3)."""
    sizes = [n // world + (1 if k < n % world else 0) for k in range(world)]
    lo = sum(sizes[:r])
    return lo, lo + sizes[r]


def _elastic_worker(args) -> int:
    """One rank of phase 45: ``elastic_train`` on the main-path rows of
    ``args["data"]`` (the rank's block at each world size, on the card),
    gloo, one checkpoint a round; its model bytes, launches (counted from
    this process image's start) and each hoist plan pickled to
    ``args["out"]``. A re-executed image runs this again with the same
    arguments."""
    from xgboost_tpu_torch.data.quantile import BinnedMatrix

    torch.backends.cuda.matmul.allow_tf32 = False
    X = np.load(os.path.join(args["data"], "Xtr.npy"), mmap_mode="r")
    y = np.load(os.path.join(args["data"], "ytr.npy"))

    def data_fn(r, world):
        lo, hi = _elastic_block(len(X), r, world)
        return xgbt.DMatrix(np.ascontiguousarray(X[lo:hi]), y[lo:hi])

    plans = []
    orig = BinnedMatrix.fused_onehot

    def fused_onehot(self, group=None):
        out = orig(self, group)
        plan = (int(self.bins.shape[0]), int(self._hoist_fh))
        if plan not in plans:
            plans.append(plan)
            print(f"elastic worker {args['rank']}: hoist plan Fh "
                  f"{plan[1]}/{COLS} on {plan[0]} rows", flush=True)
        return out

    BinnedMatrix.fused_onehot = fused_onehot
    kill = os.kill

    def logged_kill(pid, sig):
        """The victim's SIGKILL (the ``worker_kill`` chaos site), its
        instant written first."""
        if pid == os.getpid() and sig == signal.SIGKILL:
            with open(args["out"] + ".killed", "w") as f:
                f.write(repr(time.time()))
        kill(pid, sig)

    os.kill = logged_kill
    reset_launches()
    bst = xgbt.elastic_train(
        ELASTIC_PARAMS, data_fn, ELASTIC_ROUNDS, run_dir=args["run"],
        world=args["world"], rank=args["rank"],
        coordinator=f"localhost:{args['port']}", backend="gloo")
    torch.cuda.synchronize()
    with open(args["out"], "wb") as f:
        pickle.dump(dict(raw=bytes(bst.save_raw()), launches=launches(),
                         plans=plans), f)
    xgbt.elastic_exit(0)
    return 0


def _free_port_pair() -> int:
    """A base port whose successor is free too (generation 1 meets
    there)."""
    import socket

    while True:
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        try:
            with socket.socket() as s:
                s.bind(("localhost", port + 1))
            return port
        except OSError:
            continue


def _elastic_world(tmp, tag, world, victim):
    """Run one world of phase 45 (``victim`` armed with ``worker_kill``) to
    its end: ``(run_dir, [(exit code, output)], results of the survivors by
    rank)``. Every process it starts is stopped."""
    import threading

    run = os.path.join(tmp, f"run_{tag}")
    port = _free_port_pair()
    procs = []
    for r in range(world):
        args = dict(data=tmp, run=run, rank=r, world=world, port=port,
                    out=os.path.join(tmp, f"{tag}_rank{r}.pkl"))
        env = dict(os.environ, XGBTPU_HEARTBEAT=ELASTIC_HEARTBEAT)
        env.pop("XGBTPU_CHAOS", None)
        if r == victim:
            env["XGBTPU_CHAOS"] = f"worker_kill:permanent:{ELASTIC_KILL_HIT}"
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--elastic-worker",
             json.dumps(args)],
            cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    ends = [None] * world

    def wait(r):
        out = procs[r].communicate(timeout=400)[0]
        ends[r] = (procs[r].returncode, out)

    threads = [threading.Thread(target=wait, args=(r,)) for r in range(world)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=420)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, end in enumerate(ends):
        check(end is not None, f"elastic {tag}: rank {r} did not end")
    survivors = {}
    for r, (rc, out) in enumerate(ends):
        if r == victim:
            check(rc == -signal.SIGKILL,
                  f"elastic {tag}: rank {r} exit {rc}: {out[-3000:]}")
            continue
        check(rc == 0, f"elastic {tag}: rank {r} exit {rc}: {out[-3000:]}")
        for ln in out.splitlines():
            if "hoist plan" in ln or "re-executing" in ln:
                print(ln.split("] ", 1)[-1])
        with open(os.path.join(tmp, f"{tag}_rank{r}.pkl"), "rb") as f:
            survivors[r] = pickle.load(f)
    return run, ends, survivors


def _flight_records(run, rank):
    recs = []
    with open(os.path.join(run, "obs", f"rank{rank}", "flight.jsonl")) as f:
        for ln in f:
            try:
                recs.append(json.loads(ln))
            except ValueError:
                pass  # a torn last line
    return recs


def _first(recs, t, name=None, gen=None):
    for rec in recs:
        if rec.get("t") == t and (name is None or rec.get("name") == name) \
                and (gen is None or rec.get("gen") == gen):
            return rec
    return None


def phase_elastic(Xtr, ytr):
    """Phase 45: elastic training on the main path (1M x 50, max_bin 256,
    depth 6, eta 0.1, 10 rounds, a checkpoint every round, heartbeats every
    0.25 s), each rank a process running this script with
    ``--elastic-worker`` on the card, two or three ranks on the one card
    over gloo. (a) 2 -> 1: blocks of 500,000 rows, rank 1 SIGKILLed at its
    5th round boundary; the survivor shrinks to one in its process and
    replays from the newest verified checkpoint on all 1M rows. (b) 3 -> 2:
    blocks of 333,334 / 333,333 / 333,333, rank 2 killed the same way; both
    survivors restart their process images (``os.execv``) for generation
    1. Every survivor's model bytes equal a straight single-process run on
    the card. Printed: each generation's hoist plan (Fh), the survivors'
    launches, the seconds from the SIGKILL (the victim writes its instant
    just before) to the survivor's raise (its ``train_abort`` flight
    event) and to its heartbeat verdict (``worker_lost``) beside
    ``hb_deadline()``, from the raise to the first replayed round, the
    rounds replayed, the survivor's median round before and after the
    resize, and in (b) the seconds from the resize to the restarted
    image's flight meta line and to its first round."""
    from xgboost_tpu_torch.parallel.membership import hb_deadline

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="xgbt_elastic_")
    np.save(os.path.join(tmp, "Xtr.npy"), Xtr)
    np.save(os.path.join(tmp, "ytr.npy"), ytr)
    reset_launches()
    bst = xgbt.train(ELASTIC_PARAMS, xgbt.DMatrix(Xtr, ytr), ELASTIC_ROUNDS,
                     verbose_eval=False)
    straight = bytes(bst.save_raw())
    straight_l = launches()
    del bst
    torch.cuda.empty_cache()
    os.environ["XGBTPU_HEARTBEAT"] = ELASTIC_HEARTBEAT
    deadline = hb_deadline()
    del os.environ["XGBTPU_HEARTBEAT"]

    run_a, ends_a, surv_a = _elastic_world(tmp, "a", 2, victim=1)
    check(surv_a[0]["raw"] == straight,
          "elastic (a): the survivor's model == the straight run's bytes")
    recs = _flight_records(run_a, 0)
    with open(os.path.join(tmp, "a_rank1.pkl.killed")) as f:
        kill_t = float(f.read())
    abort = _first(recs, "event", "train_abort")
    lost = _first(recs, "event", "worker_lost")
    replay = _first(recs, "event", "elastic_replay")
    first = _first(recs, "round", gen=1)
    check(None not in (abort, lost, replay, first),
          "elastic (a): abort, worker_lost, replay and a generation-1 round "
          "in the survivor's flight records")
    gen_wall = {g: [r["wall_s"] * 1e3 for r in recs
                    if r.get("t") == "round" and r.get("gen") == g]
                for g in (0, 1)}
    a = dict(
        launches=surv_a[0]["launches"], plans=surv_a[0]["plans"],
        hb_deadline_s=deadline,
        kill_to_raise_s=abort["unix_ms"] / 1e3 - kill_t,
        kill_to_declared_dead_s=lost["unix_ms"] / 1e3 - kill_t,
        raise_to_first_replayed_round_s=(first["unix_ms"] - abort["unix_ms"])
        / 1e3,
        raise_to_first_replayed_round_end_s=(
            first["unix_ms"] / 1e3 + first["wall_s"] - abort["unix_ms"] / 1e3),
        rounds_replayed=replay["args"]["replayed"],
        resumed_from=replay["args"]["resumed"],
        median_round_ms_world2=statistics.median(gen_wall[0]),
        median_round_ms_world1=statistics.median(gen_wall[1]),
        abort_error=abort.get("args", {}).get("detail", ""))
    resumed = a["resumed_from"]
    got = a["launches"]
    # one one-hot a generation, a fill walk a resumed round, six levels a
    # finished round of either generation (and the levels of the round in
    # flight at the kill)
    check(got["A"] == 0 and got["C"] == 2 and got["B"] == resumed
          and DEPTH * ELASTIC_ROUNDS <= got["D"]
          < DEPTH * (ELASTIC_ROUNDS + 1),
          f"elastic (a): survivor launches {got}, resumed from {resumed}")
    print(f"elastic (a) 2 -> 1: survivor bytes == straight ({len(straight)} "
          f"bytes); launches {got} (straight run {straight_l}); SIGKILL -> "
          f"raise {a['kill_to_raise_s']:.3f} s ({a['abort_error'][:90]}), "
          f"-> declared dead {a['kill_to_declared_dead_s']:.3f} s "
          f"(hb_deadline {deadline:g} s); raise -> first replayed round "
          f"{a['raise_to_first_replayed_round_s']:.3f} s (its end "
          f"{a['raise_to_first_replayed_round_end_s']:.3f} s); rounds "
          f"replayed {a['rounds_replayed']} (resumed from {resumed}); median "
          f"round world 2 {a['median_round_ms_world2']:.1f} ms, world 1 "
          f"{a['median_round_ms_world1']:.1f} ms")

    run_b, ends_b, surv_b = _elastic_world(tmp, "b", 3, victim=2)
    b = dict(launches={}, plans={}, resize_to_restart_s={},
             resize_to_first_round_s={})
    for r in (0, 1):
        check(surv_b[r]["raw"] == straight,
              f"elastic (b): survivor {r}'s model == the straight run's")
        check("re-executing worker for generation 1" in ends_b[r][1],
              f"elastic (b): survivor {r} restarted its process image")
        recs = _flight_records(run_b, r)
        resize = _first(recs, "event", "elastic_resize")
        metas = [m for m in recs if m.get("t") == "meta"]
        first = _first(recs, "round", gen=1)
        check(resize is not None and len(metas) == 2 and first is not None,
              f"elastic (b): survivor {r}'s resize, restart and first round")
        b["launches"][r] = got = surv_b[r]["launches"]
        check(got["A"] == 0 and got["C"] == 1
              and got["D"] % DEPTH == 0 and got["D"] > 0,
              f"elastic (b): restarted survivor {r}'s launches {got}")
        b["plans"][r] = surv_b[r]["plans"]
        b["resize_to_restart_s"][r] = (metas[1]["unix_ms"]
                                       - resize["unix_ms"]) / 1e3
        b["resize_to_first_round_s"][r] = (first["unix_ms"]
                                           - resize["unix_ms"]) / 1e3
    print(f"elastic (b) 3 -> 2 by re-exec: both survivors' bytes == "
          f"straight; launches of the restarted images {b['launches']}; "
          f"resize -> restarted image's first flight line "
          f"{b['resize_to_restart_s']} s, -> its first round "
          f"{b['resize_to_first_round_s']} s")
    out = dict(a=a, b=b, straight_launches=straight_l,
               phase_s=time.perf_counter() - t_phase)
    print(f"elastic: phase {out['phase_s']:.1f} s")
    return out, tmp, run_a


def _cli(args, cwd):
    """``python -m xgboost_tpu_torch <args>`` from this checkout: its exit
    code and output."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-m", "xgboost_tpu_torch", *args],
                         cwd=cwd, env=env, capture_output=True, text=True,
                         timeout=600)
    return out.returncode, out.stdout + out.stderr


def _write_libsvm(path, X, y):
    fmt = ["%d"] + [f"{j}:%.9g" for j in range(X.shape[1])]
    np.savetxt(path, np.column_stack([y, X]), fmt=fmt, delimiter=" ")


def phase_cli(Xtr, ytr, Xte, yte, elastic, tmp, run_a):
    """Phase 46: the command line on the card. The first 100,000 main-path
    rows and the first 50,000 held-out rows as libsvm files; ``python -m
    xgboost_tpu_torch`` with a config file (no ``device`` line: the card)
    for ``train`` (10 rounds, the main path's parameters), ``pred`` and
    ``dump``; the predictions equal ``Booster.predict`` on the card to the
    printed digits, the dump equals ``get_dump()``. ``obs-report`` on phase
    45 (a)'s run directory shows its 2 ranks, the worker_lost /
    elastic_quiesce / elastic_resize / elastic_replay events and its
    replayed rounds; ``checkpoint-inspect`` on its checkpoints marks the
    newest verified one."""
    t_phase = time.perf_counter()
    cdir = os.path.join(tmp, "cli")
    os.makedirs(cdir)
    t0 = time.perf_counter()
    _write_libsvm(os.path.join(cdir, "train.libsvm"), Xtr[:CLI_ROWS],
                  ytr[:CLI_ROWS])
    Xte, yte = Xte[:CLI_TEST_ROWS], yte[:CLI_TEST_ROWS]
    _write_libsvm(os.path.join(cdir, "test.libsvm"), Xte, yte)
    write_s = time.perf_counter() - t0
    params = "".join(f"{k}={v}\n" for k, v in ELASTIC_PARAMS.items()
                     if k != "eval_metric")
    confs = {
        "train": f"task=train\ndata=train.libsvm\nnum_round="
                 f"{ELASTIC_ROUNDS}\nmodel_out=model.json\nsilent=1\n",
        "pred": "task=pred\nmodel_in=model.json\ntest:data=test.libsvm\n"
                "name_pred=pred.txt\n",
        "dump": "task=dump\nmodel_in=model.json\nname_dump=dump.txt\n"}
    secs = {}
    for task, body in confs.items():
        with open(os.path.join(cdir, f"{task}.conf"), "w") as f:
            f.write(body + params)
        t0 = time.perf_counter()
        rc, text = _cli([f"{task}.conf"], cdir)
        secs[task] = time.perf_counter() - t0
        check(rc == 0, f"cli {task}: exit {rc}: {text[-3000:]}")
    bst = xgbt.Booster(model_file=os.path.join(cdir, "model.json"))
    check(bst.device.type == "cuda" and bst.num_boosted_rounds()
          == ELASTIC_ROUNDS, "cli: the model loads on the card, 10 rounds")
    preds = bst.predict(xgbt.DMatrix(Xte))
    with open(os.path.join(cdir, "pred.txt")) as f:
        lines = f.read().split()
    check(lines == ["%.9g" % v for v in preds],
          "cli: pred.txt == Booster.predict on the card, digit for digit")
    with open(os.path.join(cdir, "dump.txt")) as f:
        dumped = f.read()
    check(dumped == "".join(f"booster[{i}]:\n{d}\n"
                            for i, d in enumerate(bst.get_dump())),
          "cli: dump.txt == get_dump()")
    del bst
    rc, report = _cli(["obs-report", run_a], cdir)
    a = elastic["a"]
    check(rc == 0 and "obs-report: 2 rank(s)" in report
          and all(f"  {ev}: " in report for ev in
                  ("worker_lost", "elastic_quiesce", "elastic_resize",
                   "elastic_replay"))
          and f"{a['rounds_replayed']} replayed" in report,
          f"cli: obs-report on the elastic run: {report[-3000:]}")
    rc, inspect = _cli(["checkpoint-inspect",
                        os.path.join(run_a, "checkpoints")], cdir)
    marked = [ln for ln in inspect.splitlines() if ln.startswith("*")]
    check(rc == 0 and len(marked) == 1 and "verified" in marked[0]
          and f"ckpt_{ELASTIC_ROUNDS:08d}" in marked[0],
          f"cli: checkpoint-inspect: {inspect[-2000:]}")
    print("cli: " + " ".join(ln for ln in report.splitlines()
                             if "per-round fleet table" in ln))
    print(f"cli: train / pred / dump {secs['train']:.1f} / "
          f"{secs['pred']:.1f} / {secs['dump']:.1f} s (process start, "
          f"libsvm parse and the task), libsvm write {write_s:.1f} s; "
          f"predictions and dump == the Booster's on the card; "
          f"checkpoint-inspect marks {marked[0].split()[-1]}")
    shutil.rmtree(tmp, ignore_errors=True)
    return dict(task_s=secs, write_s=write_s,
                phase_s=time.perf_counter() - t_phase)


SERVE_THREADS, SERVE_REQUESTS, SERVE_WAIT_US = 8, 400, 500
SERVE_LATENCY_ROWS = ((1, 30), (16, 30), (256, 30), (4096, 8))
SERVE_THROUGHPUT_REPS = 10
SERVE_CLI_ROWS = 1000


def _serve_stream(rows: int):
    """``bench.py:_served_bench``'s stream: 400 requests of 1-64 rows at
    random offsets, from seed 11."""
    rng = np.random.RandomState(11)
    return [(int(lo), int(n)) for lo, n in zip(
        rng.randint(0, max(1, rows - 64), SERVE_REQUESTS),
        rng.randint(1, 65, SERVE_REQUESTS))]


def _serve_clients(srv, X, reqs, name="m", on_answer=None):
    """``reqs`` from ``SERVE_THREADS`` client threads (request k on thread
    k % 8, as ``bench.py`` shards them): the wall seconds, the answers by
    request index and the errors."""
    import threading

    out, errors = {}, []

    def client(k):
        try:
            for i in range(k, len(reqs), SERVE_THREADS):
                lo, n = reqs[i]
                out[i] = srv.predict(name, X[lo:lo + n], timeout=120)
                if on_answer is not None:
                    on_answer(i)
        except Exception as e:  # noqa: BLE001 — checked by the caller
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(k,))
               for k in range(SERVE_THREADS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    return time.perf_counter() - t0, out, errors


def _registry_value(name, **labels):
    fam = REGISTRY.get(name)
    return 0.0 if fam is None else fam.labels(**labels).value


def _walk_at(forest, X, what):
    """Kernel B at ``X``'s rows: its time alone, the wrapper's time, the
    plain version's, and the bound of the work this data needs."""
    n = X.shape[0]
    base = torch.zeros((n, 1), device=X.device)
    tw = torch.ones(forest.num_trees, device=X.device)
    run = lambda: predict_margin(forest, X, base, tw)  # noqa: E731
    got = run()
    want = _predict_margin_plain(forest, X, base, tw)
    torch.cuda.synchronize()
    check(torch.equal(got, want), f"serving: kernel B == plain at {what}")
    T, N = forest.left.shape
    x_bytes, tests = walk_need(forest, X)
    bnd, by = bound_ms(x_bytes + 2 * n * 4 + T * N * 16 + T * 8, tests * 2)
    rec = dict(rows=n, ms=time_ms(run), kernel_ms=kernel_ms(run, "B"),
               plain_ms=time_ms(lambda: _predict_margin_plain(
                   forest, X, base, tw)),
               bound_ms=bnd, bound_by=by, max_abs_err=0.0)
    print(f"serving: kernel B at {what}: {rec['ms']:.4f} ms "
          f"(alone {rec['kernel_ms']} ms) plain {rec['plain_ms']:.4f} ms "
          f"bound {bnd:.6f} ms ({by})")
    return rec


def _dispatch_split(srv, X, reqs):
    """Phase 47 (g): where a served dispatch's time goes. Each dispatch's
    whole time (``MicroBatcher._dispatch_group``) and the part of it in
    ``ModelEntry.predict`` (the rows' copy, kernel B, the transform, the
    copy back), medians, with the 8 clients active (the closed loop of
    (c): a client submits its next request as soon as its answer comes,
    while the worker dispatches) and parked (each round the 8 clients
    submit one request each, then wait on a barrier until all 8 are
    answered, so no client runs while the round's later dispatches run),
    and the same predicts called in turn from one thread."""
    import threading

    from xgboost_tpu_torch.serving import batcher

    entry = srv.registry.get("m")
    real_predict = entry.predict
    real_group = batcher.MicroBatcher._dispatch_group
    walk, whole = [], []

    def timed_predict(rows, **kw):
        t0 = time.perf_counter()
        res = real_predict(rows, **kw)
        walk.append(time.perf_counter() - t0)
        return res

    def timed_group(self, grp, gen):
        t0 = time.perf_counter()
        real_group(self, grp, gen)
        whole.append(time.perf_counter() - t0)

    def summary(wall):
        check(len(walk) == len(whole),
              "serving: (g) one predict a dispatch")
        rec = dict(wall_s=wall, dispatches=len(whole),
                   requests_per_dispatch=len(reqs) / max(len(whole), 1),
                   dispatch_ms=statistics.median(whole) * 1e3,
                   predict_ms=statistics.median(walk) * 1e3,
                   rest_ms=statistics.median(
                       w - p for w, p in zip(whole, walk)) * 1e3)
        walk.clear()
        whole.clear()
        return rec

    def parked_clients():
        rounds = -(-len(reqs) // SERVE_THREADS)
        barrier = threading.Barrier(SERVE_THREADS)
        errors = []

        def client(k):
            try:
                for r in range(rounds):
                    i = r * SERVE_THREADS + k
                    if i < len(reqs):
                        lo, n = reqs[i]
                        srv.predict_async("m", X[lo:lo + n]).result(120)
                    barrier.wait(120)
            except Exception as e:  # noqa: BLE001 — checked below
                errors.append(repr(e))
                barrier.abort()

        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(SERVE_THREADS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        check(not errors, f"serving: (g) parked clients {errors[:3]}")
        return time.perf_counter() - t0

    entry.predict = timed_predict
    batcher.MicroBatcher._dispatch_group = timed_group
    try:
        _serve_clients(srv, X, reqs)  # warm
        walk.clear()
        whole.clear()
        wall, _, errors = _serve_clients(srv, X, reqs)
        check(not errors, f"serving: (g) stream errors {errors[:3]}")
        active = summary(wall)
        parked = summary(parked_clients())
        t0 = time.perf_counter()
        for lo, n in reqs:
            timed_predict(X[lo:lo + n])
        alone = dict(wall_s=time.perf_counter() - t0,
                     predict_ms=statistics.median(walk) * 1e3)
        walk.clear()
    finally:
        batcher.MicroBatcher._dispatch_group = real_group
        entry.predict = real_predict
    for what, rec in (("active", active), ("parked", parked)):
        print(f"serving: (g) clients {what}: {rec['dispatches']} dispatches "
              f"({rec['requests_per_dispatch']:.2f} requests each) in "
              f"{rec['wall_s']:.4f} s; a dispatch {rec['dispatch_ms']:.4f} ms"
              f" (median): its predict {rec['predict_ms']:.4f}, the rest "
              f"{rec['rest_ms']:.4f}")
    print(f"serving: (g) the same predicts in turn from one thread: "
          f"{alone['predict_ms']:.4f} ms each (median), "
          f"{alone['wall_s']:.4f} s")
    return dict(active=active, parked=parked, alone=alone)


def _dispatch_ops(srv, X, requests: int = 20):
    """Phase 47 (g): what one served request costs each thread (the
    caller's, the batcher's worker, the access-log writer): lock releases
    (one per acquisition), metric registry lookups (``_family``), labelled
    child lookups (``labels``) and calls into torch, counted by a profile
    hook on every thread over ``requests`` one-request dispatches."""
    import threading
    from collections import Counter

    from xgboost_tpu_torch.observability import metrics

    names = {metrics.MetricsRegistry._family.__code__: "registry",
             metrics.MetricFamily.labels.__code__: "labels"}
    counts = {}

    def hook(frame, event, arg):
        key = None
        if event == "call":
            key = names.get(frame.f_code)
        elif event == "c_call":
            owner = getattr(arg, "__self__", None)
            if getattr(arg, "__name__", "") in (
                    "__exit__", "release", "_release_save") \
                    and type(owner).__name__ in ("lock", "RLock"):
                key = "locks"
            elif isinstance(owner, torch.Tensor) or (
                    getattr(arg, "__module__", None) or "").startswith(
                        "torch"):
                key = "torch"
        if key is not None:
            counts.setdefault(threading.current_thread().name,
                              Counter())[key] += 1

    srv.predict("m", X[:4], timeout=120)
    srv.obs.drain()
    threading.setprofile_all_threads(hook)
    try:
        for _ in range(requests):
            srv.predict("m", X[:4], timeout=120)
        srv.obs.drain()
    finally:
        threading.setprofile_all_threads(None)
    roles = {threading.current_thread().name: "caller",
             "xgbtpu-serving-batcher": "worker",
             "xgbtpu-serve-obs": "writer"}
    out = {roles[t]: {k: v / requests for k, v in sorted(c.items())}
           for t, c in counts.items() if t in roles}
    print(f"serving: (g) per one-request dispatch: {out}")
    return out


def phase_serving_walks(bst, Xte):
    """Phase 47 (a)'s kernel B at the served batch sizes, 16 and 4,096
    rows, on the reference-default model's forest, taken right after that
    model is trained: late in a run ``torch.profiler`` keeps few of kernel
    B's records (0 of 20 at the end of a whole run)."""
    forest, _ = bst._forest_snapshot()
    Xd = torch.as_tensor(Xte, device=DEVICE)
    return {f"rows_{n}": _walk_at(forest, Xd[:n], f"{n} rows")
            for n in (16, 4096)}


def phase_serving(raw256, Xtr, ytr, Xte, yte, walks):
    """Phase 47: the serving layer on the card (module docstring, 47);
    ``walks`` is ``phase_serving_walks``'s record."""
    import threading

    from xgboost_tpu_torch.predictor import serving as psrv
    from xgboost_tpu_torch.resilience import chaos
    from xgboost_tpu_torch.serving import ModelServer, RequestError

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_serving_")
    path = os.path.join(tmp, "m256.json")
    with open(path, "wb") as f:
        f.write(raw256)
    bst = xgbt.Booster(model_file=path, device=DEVICE)
    cpu = xgbt.Booster(model_file=path, device="cpu")
    check(bst.num_boosted_rounds() == ROUNDS, "serving: the 10-round model")
    out = {}
    reset_launches()
    # (a) parity on the 100k held-out rows
    with psrv.serving_context():
        margin = bst.inplace_predict(Xte, predict_type="margin")
        route = psrv.last_route()
    check(route == "kernel", f"serving: inplace_predict route {route!r}")
    fresh = bst.predict(xgbt.DMatrix(Xte, device=DEVICE), output_margin=True)
    plain = cpu.inplace_predict(Xte, predict_type="margin")
    check(np.array_equal(margin, fresh),
          "serving: inplace_predict == predict margins of a fresh DMatrix")
    check(np.array_equal(margin, plain),
          "serving: inplace_predict == kernel B's plain version on the CPU")
    value = bst.inplace_predict(Xte)
    check(np.array_equal(value, cpu.inplace_predict(Xte)),
          "serving: values == the CPU's bit for bit")
    auc = float(create_metric("auc").evaluate(
        torch.as_tensor(value), torch.as_tensor(yte)))
    out["kernel_B"] = walks
    print(f"serving: (a) 100k held-out rows, inplace == predict == CPU "
          f"plain bit for bit, AUC {auc:.6f}")
    # (b) bench.py's latency sweep and throughput
    lat = {}
    for n, reps in SERVE_LATENCY_ROWS:
        xb = np.ascontiguousarray(Xte[:n])
        bst.inplace_predict(xb)
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            bst.inplace_predict(xb)
            ts.append((time.perf_counter() - t0) * 1e3)
        lat[n] = statistics.median(ts)

    def rows_per_s(fn):
        fn()
        t0 = time.perf_counter()
        for _ in range(SERVE_THROUGHPUT_REPS):
            fn()
        return EVAL_ROWS * SERVE_THROUGHPUT_REPS / (time.perf_counter() - t0)

    rps_d = rows_per_s(lambda: bst.predict(xgbt.DMatrix(Xte, device=DEVICE)))
    rps_i = rows_per_s(lambda: bst.inplace_predict(Xte))
    out.update(latency_ms=lat, dmatrix_rows_per_s=rps_d,
               inplace_rows_per_s=rps_i)
    print("serving: (b) inplace latency (median ms) " + ", ".join(
        f"{n} rows {v:.4f}" for n, v in lat.items())
        + f"; 100k rows in place {rps_i:,.0f} rows/s, DMatrix path "
          f"{rps_d:,.0f} rows/s")
    # (c) the concurrent stream against the same stream sequentially
    reqs = _serve_stream(EVAL_ROWS)
    total_rows = sum(n for _, n in reqs)
    seq_ref = {}

    def run_sequential():
        t0 = time.perf_counter()
        for i, (lo, n) in enumerate(reqs):
            seq_ref[i] = bst.inplace_predict(Xte[lo:lo + n])
        return time.perf_counter() - t0

    srv = ModelServer(batch_wait_us=SERVE_WAIT_US, device=DEVICE)
    try:
        srv.load("m", path)
        run_sequential()
        _, answers, errors = _serve_clients(srv, Xte, reqs)
        check(not errors, f"serving: warm stream errors {errors[:3]}")
        check(len(answers) == SERVE_REQUESTS and all(
            np.array_equal(answers[i], seq_ref[i]) for i in answers),
            "serving: every served response == inplace_predict of its rows")
        seq_t, srv_t, b_launch, disp = [], [], 0, 0
        b0 = _registry_value("serving_requests_batched_total")
        for _ in range(5):
            seq_t.append(run_sequential())
            l0 = predict_margin.launches
            d0 = _registry_value("serving_dispatches_total")
            wall, answers, errors = _serve_clients(srv, Xte, reqs)
            srv_t.append(wall)
            b_launch += predict_margin.launches - l0
            disp += _registry_value("serving_dispatches_total") - d0
            check(not errors and len(answers) == SERVE_REQUESTS,
                  f"serving: stream errors {errors[:3]}")
        batched = _registry_value("serving_requests_batched_total") - b0
        check(b_launch == disp, f"serving: kernel B launches {b_launch} == "
              f"coalesced dispatches {disp}")
        seq_rps = total_rows / statistics.mean(seq_t)
        served_rps = total_rows / statistics.mean(srv_t)
        stages = {st: {k: v * 1e3 for k, v in qs.items()}
                  for st, qs in srv.stats()["slo"]["stages"].items()}
        out["stream"] = dict(
            served_rows_per_s=served_rps, sequential_rows_per_s=seq_rps,
            rows=total_rows, dispatches=disp, kernel_B_launches=b_launch,
            coalesce_ratio=batched / max(disp, 1), stage_ms=stages)
        print(f"serving: (c) {SERVE_THREADS} threads x {SERVE_REQUESTS} "
              f"requests ({total_rows} rows): served {served_rps:,.0f} "
              f"rows/s, sequential {seq_rps:,.0f} rows/s (means of 5, "
              f"interleaved); {disp:.0f} dispatches, kernel B {b_launch} "
              f"launches, coalescing {batched / max(disp, 1):.2f} req/"
              "dispatch; stages (ms) " + "; ".join(
                  f"{st} p50 {qs.get('p50', 0):.4f} p99 "
                  f"{qs.get('p99', 0):.4f}" for st, qs in stages.items()))
        # (g) where a served dispatch's time goes, and what it costs
        out["dispatch_split"] = _dispatch_split(srv, Xte, reqs)
        out["ops_per_request"] = _dispatch_ops(srv, Xte)
        # (d) a hot swap mid-stream to the model continued for 10 rounds
        t0 = time.perf_counter()
        more = xgbt.train(PARAMS_DEFAULT, xgbt.DMatrix(Xtr, ytr, device=DEVICE),
                          ROUNDS, xgb_model=bst)
        raw20 = more.save_raw()
        train_s = time.perf_counter() - t0
        ref20 = {i: more.inplace_predict(Xte[lo:lo + n])
                 for i, (lo, n) in enumerate(reqs)}
        started = threading.Event()
        answered = [0]

        def note(_):
            answered[0] += 1
            if answered[0] >= SERVE_REQUESTS // 4:
                started.set()

        res = {}
        runner = threading.Thread(target=lambda: res.update(zip(
            ("wall", "answers", "errors"),
            _serve_clients(srv, Xte, reqs, on_answer=note))))
        runner.start()
        check(started.wait(300), "serving: the stream started")
        t0 = time.perf_counter()
        label = srv.swap("m", raw20)
        swap_s = time.perf_counter() - t0
        runner.join(600)
        answers = res["answers"]
        check(not res["errors"] and len(answers) == SERVE_REQUESTS,
              f"serving: swap lost requests: {len(answers)} answered, "
              f"errors {res['errors'][:3]}")
        old = sum(np.array_equal(answers[i], seq_ref[i]) for i in answers)
        new = sum(np.array_equal(answers[i], ref20[i]) for i in answers)
        check(old + new == SERVE_REQUESTS and new > 0,
              f"serving: every answer one model's bits ({old} old, {new} new)")
        check(label == "m@v2" and srv.registry.get("m", 1).inflight == 0,
              "serving: the swap flipped and drained")
        out["swap"] = dict(old=old, new=new, swap_s=swap_s, train_s=train_s)
        print(f"serving: (d) hot swap to 20 rounds mid-stream in "
              f"{swap_s:.3f} s: {SERVE_REQUESTS} answered, {old} by v1 and "
              f"{new} by v2, none lost")
        # (e) scripted faults at kernel B's launch site under serving
        walks = []
        real_plain = predictor_mod._predict_margin_plain
        predictor_mod._predict_margin_plain = \
            lambda *a: walks.append(1) or real_plain(*a)
        try:
            with chaos.configure("pallas:transient:1"):
                got = srv.predict("m", Xte[:32], timeout=120)
            check(np.array_equal(got, more.inplace_predict(Xte[:32])),
                  "serving: the retried dispatch's answer")
            with chaos.configure("pallas:permanent:1") as plan:
                fut = srv.predict_async("m", Xte[:32], request_id="fault")
                try:
                    fut.result(120)
                    typed = None
                except RequestError as e:
                    typed = e
            check(typed is not None and typed.kind == "permanent"
                  and plan.fired == [("pallas", 1, "permanent")],
                  f"serving: a permanent launch fault is typed ({typed!r})")
        finally:
            predictor_mod._predict_margin_plain = real_plain
        check(walks == [], "serving: no plain walk served a faulted launch")
        breaker = srv.faults.breaker("m").snapshot()
        out["fault"] = dict(error=str(typed), breaker=breaker)
        print(f"serving: (e) pallas transient: retried and served; "
              f"permanent: {typed}; breaker {breaker}")
    finally:
        srv.close()
    out["launches"] = launches()
    # (f) the command line over stdin, on the card
    msgs = [{"op": "load", "model": "m", "path": path},
            {"op": "predict", "id": "p", "model": "m",
             "data": Xte[:SERVE_CLI_ROWS].tolist()},
            {"op": "stats"}, {"op": "shutdown"}]
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "xgboost_tpu_torch", "serve", "--stdin",
         "--device", str(DEVICE)], input="\n".join(json.dumps(m)
                                                   for m in msgs) + "\n",
        cwd=tmp, env=env, capture_output=True, text=True, timeout=600)
    cli_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"serving: serve exit {proc.returncode}: "
          f"{proc.stderr[-3000:]}")
    lines = [json.loads(ln) for ln in proc.stdout.splitlines()]
    check(len(lines) == 4 and lines[0].get("version") == "m@v1",
          f"serving: serve answers {proc.stdout[:500]}")
    check(np.array_equal(np.asarray(lines[1]["result"], np.float64),
                         value[:SERVE_CLI_ROWS].astype(np.float64)),
          "serving: serve's answers == inplace_predict digit for digit")
    check(lines[2]["stats"]["arena"]["live"] == {"m": "m@v1"},
          "serving: serve's stats")
    print(f"serving: (f) python -m xgboost_tpu_torch serve --stdin: "
          f"{SERVE_CLI_ROWS} rows == inplace_predict digit for digit, "
          f"{cli_s:.1f} s with the process start")
    shutil.rmtree(tmp, ignore_errors=True)
    out.update(cli_s=cli_s, auc=auc, phase_s=time.perf_counter() - t_phase)
    print(f"serving: phase {out['phase_s']:.1f} s, launches "
          f"{out['launches']}")
    return out


FLEET_REPLICAS, FLEET_PASSES = 2, 3
FLEET_TENANTS = ("acme", "globex")


def _fleet_rpc(port, msg, timeout=120):
    """One request line to ``port``, its answer."""
    import socket

    with socket.create_connection(("127.0.0.1", port), timeout=timeout) as c:
        c.sendall((json.dumps(msg) + "\n").encode())
        return json.loads(c.makefile("rb").readline())


def _fleet_state(run):
    with open(os.path.join(run, "fleet.json")) as f:
        return json.load(f)


def _fleet_clients(port, lines, ref, rows, until=None, on_answer=None):
    """Phase 48's stream through the router: ``lines[i]`` (pre-encoded)
    from thread i % 8, one connection a thread; with ``until``, the
    threads repeat their share of the stream until it is set. Every answer
    is held against ``ref[i]`` bit for bit as it comes. Returns the wall
    seconds, the answers and rows counted, the mismatches and the
    errors."""
    import socket
    import threading

    stats = {"answered": 0, "rows": 0}
    bad, errors = [], []
    lock = threading.Lock()

    def client(k):
        try:
            with socket.create_connection(("127.0.0.1", port),
                                          timeout=300) as c:
                rf = c.makefile("rb")
                while True:
                    for i in range(k, len(lines), SERVE_THREADS):
                        c.sendall(lines[i])
                        r = json.loads(rf.readline())
                        if "result" not in r:
                            errors.append(f"request {i}: {r}")
                            continue
                        if not np.array_equal(
                                np.asarray(r["result"], np.float64), ref[i]):
                            bad.append(i)
                        with lock:
                            stats["answered"] += 1
                            stats["rows"] += rows[i]
                        if on_answer is not None:
                            on_answer()
                    if until is None or until.is_set():
                        return
        except Exception as e:  # noqa: BLE001 — checked by the caller
            errors.append(f"client {k}: {e!r}")

    threads = [threading.Thread(target=client, args=(k,))
               for k in range(SERVE_THREADS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    return (time.perf_counter() - t0, stats["answered"], stats["rows"], bad,
            errors)


def _compute_apps():
    """The pids ``nvidia-smi`` lists as compute apps on the card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"fleet: nvidia-smi compute apps: "
          f"{out.stderr.strip()}")
    return [int(x) for x in out.stdout.split() if x.strip().isdigit()]


def _nvidia_fds(pid):
    """How many of ``pid``'s open files are the NVIDIA driver's device
    nodes: a process with a CUDA context holds some, a process that never
    initialised CUDA holds none."""
    n = 0
    for fd in os.listdir(f"/proc/{pid}/fd"):
        try:
            n += os.readlink(f"/proc/{pid}/fd/{fd}").startswith(
                "/dev/nvidia")
        except OSError:
            pass
    return n


def _pid_alive(pid):
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def _poll(fn, timeout, what):
    t_end = time.monotonic() + timeout
    while True:
        got = fn()
        if got:
            return got
        check(time.monotonic() < t_end, what)
        time.sleep(0.02)


def _router_counter(port, name):
    """``name``'s value in the router's exposition (0 when absent)."""
    text = _fleet_rpc(port, {"op": "metrics"})["metrics"]
    for ln in text.splitlines():
        if ln.startswith(name + " ") or ln.startswith(name + "{}"):
            return float(ln.split()[-1])
    return 0.0


def fleet_launches(fleet):
    """Kernel B's launches in phase 48's replica processes: one per
    coalesced dispatch (every dispatch record of every generation, route
    ``kernel``), per replica directory."""
    return dict(launches_per_replica={
        name: v["dispatches"] for name, v in fleet["replicas"].items()},
        generations_per_replica={
        name: v["generations"] for name, v in fleet["replicas"].items()})


def phase_fleet(raw256, Xte, serving):
    """Phase 48: the serving fleet on the card (module docstring, 48);
    ``serving`` is phase 47's record, whose sequential and single-server
    rows/s are printed beside the fleet's."""
    import threading

    from xgboost_tpu_torch.observability import fleet as obs_fleet
    from xgboost_tpu_torch.observability import trace as obs_trace
    from xgboost_tpu_torch.observability.serve_report import _pct
    from xgboost_tpu_torch.serving.fleet import HashRing

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_fleet_")
    path = os.path.join(tmp, "m256.json")
    with open(path, "wb") as f:
        f.write(raw256)
    bst = xgbt.Booster(model_file=path, device=DEVICE)
    reqs = _serve_stream(EVAL_ROWS)
    rows = [n for _, n in reqs]
    total_rows = sum(rows)
    ref = [bst.inplace_predict(Xte[lo:lo + n]).astype(np.float64)
           for lo, n in reqs]
    lines = [(json.dumps({
        "op": "predict", "id": f"q{i}", "model": ("m", "m2")[i % 2],
        "tenant": FLEET_TENANTS[(i // 2) % 2],
        "data": Xte[lo:lo + n].tolist()}) + "\n").encode()
        for i, (lo, n) in enumerate(reqs)]
    del bst
    run = os.path.join(tmp, "fleet")
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    base_apps = _compute_apps()
    out = {}
    log = []
    proc = subprocess.Popen(
        [sys.executable, "-m", "xgboost_tpu_torch", "serve-fleet",
         "--port", str(port), "--replicas", str(FLEET_REPLICAS),
         "--run-dir", run, "--model", f"m={path}", "--model", f"m2={path}",
         "--batch-wait-us", str(SERVE_WAIT_US)],
        cwd=tmp, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    threading.Thread(target=lambda: log.extend(proc.stdout),
                     daemon=True).start()
    pids = set()
    try:
        # (a) start: READY, both replicas alive, only they on the card
        t0 = time.perf_counter()
        _poll(lambda: any(ln.startswith("READY fleet") for ln in log)
              or proc.poll() is not None, 300, "fleet: READY fleet")
        check(proc.poll() is None, "fleet: serve-fleet exited before READY: "
              + "".join(log)[-3000:])
        start_s = time.perf_counter() - t0
        st = _fleet_state(run)
        reps = st["replicas"]
        check([r["replica"] for r in reps] == ["r0", "r1"]
              and all(r["alive"] for r in reps),
              f"fleet: fleet.json shows 2 replicas alive: {reps}")
        pids |= {r["pid"] for r in reps}
        apps = _compute_apps()
        if os.getpid() in apps:
            check(all(r["pid"] in apps for r in reps)
                  and proc.pid not in apps,
                  f"fleet: compute apps {apps}: replicas "
                  f"{[r['pid'] for r in reps]}, not the parent {proc.pid}")
            smi = "pids"
        elif base_apps:  # another pid namespace's pids: count them
            check(len(apps) == len(base_apps) + FLEET_REPLICAS,
                  f"fleet: compute apps {base_apps} -> {apps}: one more a "
                  "replica, none for the parent")
            smi = "count"
        else:  # nvidia-smi sees no process here: the open files decide
            smi = "none listed"
        fds = {"parent": _nvidia_fds(proc.pid),
               **{r["replica"]: _nvidia_fds(r["pid"]) for r in reps}}
        check(fds["parent"] == 0 and all(fds[r["replica"]] > 0
                                         for r in reps),
              f"fleet: /dev/nvidia* files open: {fds}")
        out["start"] = dict(fleet_s=start_s, compute_apps=apps,
                            checked_by=smi, nvidia_fds=fds,
                            ready_s={r["replica"]: r["ready_s"]
                                     for r in reps})
        print(f"fleet: (a) serve-fleet READY in {start_s:.2f} s; replicas "
              "spawn -> READY " + ", ".join(
                  f"{r['replica']} {r['ready_s']:.2f} s" for r in reps)
              + f"; compute apps {apps} (checked by {smi}), /dev/nvidia* "
              f"files {fds}: the parent holds no CUDA context")
        # (b) the stream, warm pass first, then FLEET_PASSES timed passes
        wall, n, _, bad, errors = _fleet_clients(port, lines, ref, rows)
        check(not errors and not bad and n == SERVE_REQUESTS,
              f"fleet: warm pass: {n} answered, {len(bad)} differ, "
              f"errors {errors[:3]}")
        walls = []
        for _ in range(FLEET_PASSES):
            wall, n, _, bad, errors = _fleet_clients(port, lines, ref, rows)
            check(not errors and not bad and n == SERVE_REQUESTS,
                  f"fleet: pass: {n} answered, {len(bad)} differ, "
                  f"errors {errors[:3]}")
            walls.append(wall)
        fleet_rps = total_rows / statistics.mean(walls)
        # where the router's time goes: the same stream straight to one
        # replica (no hop), and the parse and re-encode of each request
        # line that the router does on one interpreter lock
        direct = []
        for _ in range(FLEET_PASSES):
            wall, n, _, bad, errors = _fleet_clients(
                reps[0]["port"], lines, ref, rows)
            check(not errors and not bad and n == SERVE_REQUESTS,
                  f"fleet: direct pass: {n} answered, {len(bad)} differ, "
                  f"errors {errors[:3]}")
            direct.append(wall)
        direct_rps = total_rows / statistics.mean(direct)
        json_ms = []
        for ln in lines:
            t1 = time.perf_counter()
            json.dumps(json.loads(ln))
            json_ms.append((time.perf_counter() - t1) * 1e3)
        stream = serving["stream"]
        out["stream"] = dict(
            fleet_rows_per_s=fleet_rps, direct_rows_per_s=direct_rps,
            single_server_rows_per_s=stream["served_rows_per_s"],
            sequential_rows_per_s=stream["sequential_rows_per_s"],
            rows=total_rows, walls_s=walls, direct_walls_s=direct,
            request_json_ms_p50=statistics.median(json_ms),
            request_json_s_per_pass=sum(json_ms) / 1e3)
        print(f"fleet: (b) {SERVE_THREADS} threads x {SERVE_REQUESTS} "
              f"requests ({total_rows} rows) through the router, m and m2 "
              f"alternating, every answer == inplace_predict bit for bit: "
              f"fleet {fleet_rps:,.0f} rows/s (mean of {FLEET_PASSES}), "
              f"straight to r0 {direct_rps:,.0f} rows/s; phase 47: one "
              f"server {stream['served_rows_per_s']:,.0f}, sequential "
              f"{stream['sequential_rows_per_s']:,.0f} rows/s; a request "
              f"line's parse and re-encode {statistics.median(json_ms):.3f}"
              f" ms (median), {sum(json_ms):.3f} ms for the 400")

        def kill_mid_stream(rid, sig, what):
            """``sig`` to replica ``rid`` a quarter into a pass; the
            clients stream on until its respawn is READY and serving."""
            k = int(rid[1:])
            old = _fleet_state(run)["replicas"][k]
            until, quarter = threading.Event(), threading.Event()
            count = [0]

            def note():
                count[0] += 1
                if count[0] >= SERVE_REQUESTS // 4:
                    quarter.set()

            rr0 = _router_counter(port, "fleet_reroutes_total")
            res = {}
            runner = threading.Thread(target=lambda: res.update(zip(
                ("wall", "n", "rows", "bad", "errors"),
                _fleet_clients(port, lines, ref, rows, until=until,
                               on_answer=note))))
            runner.start()
            check(quarter.wait(300), f"fleet: ({what}) the pass started")
            t_sig = time.time()
            os.kill(old["pid"], sig)

            def respawned():
                rep = _fleet_state(run)["replicas"][k]
                return rep if (rep["pid"] != old["pid"] and rep["alive"]
                               and rep["generation"] > old["generation"]
                               ) else None

            rep = _poll(respawned, 300, f"fleet: ({what}) {rid} respawned")
            pids.add(rep["pid"])
            at = count[0]
            _poll(lambda: count[0] >= at + SERVE_REQUESTS, 300,
                  f"fleet: ({what}) traffic after the respawn")
            until.set()
            runner.join(600)
            check(not res["errors"] and not res["bad"],
                  f"fleet: ({what}) {res['n']} answered, {len(res['bad'])} "
                  f"differ, errors {res['errors'][:3]}")
            reroutes = _router_counter(port, "fleet_reroutes_total") - rr0
            check(reroutes >= 1, f"fleet: ({what}) fleet_reroutes_total "
                  f"rose by {reroutes}")
            with open(f"/proc/{rep['pid']}/cmdline", "rb") as f:
                argv = f.read().split(b"\0")
            check(b"--model" not in argv,
                  f"fleet: ({what}) the respawn was given no model: {argv}")
            for name in ("m", "m2"):
                lo, n = reqs[0]
                r = _fleet_rpc(rep["port"], {"op": "predict", "model": name,
                                             "data": Xte[lo:lo + n].tolist()})
                check("result" in r and np.array_equal(
                    np.asarray(r["result"], np.float64), ref[0]),
                    f"fleet: ({what}) the respawn serves {name} from the "
                    f"manifest: {str(r)[:300]}")
            signal_to_ready = rep["ready_unix_ms"] / 1e3 - t_sig
            rec = dict(replica=rid, old_pid=old["pid"], new_pid=rep["pid"],
                       generation=rep["generation"], answered=res["n"],
                       reroutes=reroutes, signal_to_ready_s=signal_to_ready,
                       spawn_to_ready_s=rep["ready_s"])
            print(f"fleet: ({what}) {rid} (pid {old['pid']}) signalled a "
                  f"quarter into a pass: {res['n']} answered, none lost or "
                  f"changed, {reroutes:.0f} re-routed; respawned as pid "
                  f"{rep['pid']} generation {rep['generation']}, signal -> "
                  f"READY {signal_to_ready:.2f} s (spawn -> READY "
                  f"{rep['ready_s']:.2f} s), m and m2 served from the "
                  "manifest alone")
            return rec

        # (c) SIGTERM the hash owner of m, (d) SIGKILL the other
        owner = HashRing(["r0", "r1"]).lookup("m")
        other = "r1" if owner == "r0" else "r0"
        out["sigterm"] = kill_mid_stream(owner, signal.SIGTERM, "c")
        out["sigkill"] = kill_mid_stream(other, signal.SIGKILL, "d")
        # (g) SIGTERM the fleet: exit 0, nothing of it left on the card
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(120)
        check(rc == 0, f"fleet: serve-fleet exit {rc}: "
              + "".join(log)[-3000:])
        _poll(lambda: not any(_pid_alive(p) for p in pids), 60,
              f"fleet: replicas {pids} outlived the fleet")
        apps = _compute_apps()
        check(not (pids | {proc.pid}) & set(apps)
              and len(apps) <= len(base_apps),
              f"fleet: compute apps after the fleet {apps} (before "
              f"{base_apps})")
        print(f"fleet: (g) SIGTERM: serve-fleet exit 0, compute apps "
              f"{base_apps} -> {apps}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(30)
        for p in pids:
            try:
                os.kill(p, signal.SIGKILL)
            except OSError:
                pass
    # (e) kernel B behind every dispatch of every replica generation
    per_replica = {}
    for k in range(FLEET_REPLICAS):
        d = os.path.join(run, f"replica{k}", "obs", "server")
        sink = obs_fleet.load_obs_dir(d)  # a SIGKILL's torn line skipped
        flight = sink.flight
        access = [r for r in sink._read_jsonl(
            os.path.join(d, "access.jsonl")) if r.get("t") == "req"]
        disp = [r for r in flight if r.get("t") == "dispatch"]
        routes = {r.get("route") for r in disp} | {
            r["route"] for r in access if "route" in r}
        ok = [r for r in access if r.get("outcome") == "ok"]
        check(routes == {"kernel"} and all(r.get("route") == "kernel"
                                           for r in ok),
              f"fleet: replica{k} routes {routes}")
        ds = sorted(r["dispatch_s"] for r in ok if "dispatch_s" in r)
        per_replica[f"replica{k}"] = dict(
            generations=sum(r.get("t") == "meta" for r in flight),
            dispatches=len(disp), requests=len(access), ok=len(ok),
            dispatch_p50_ms=_pct(ds, 0.50) * 1e3,
            dispatch_p99_ms=_pct(ds, 0.99) * 1e3)
    out["replicas"] = per_replica
    print("fleet: (e) every dispatch and access line of every generation "
          "on route kernel (kernel B): " + "; ".join(
              f"{name} {v['generations']} generations, {v['dispatches']} "
              f"dispatches = kernel B launches, {v['ok']} requests served, "
              f"dispatch p50 {v['dispatch_p50_ms']:.3f} ms p99 "
              f"{v['dispatch_p99_ms']:.3f} ms"
              for name, v in per_replica.items()))
    # (f) serve-report and obs-report over both replicas (the two
    # processes at once; neither writes what the other reads)
    reports = {sub: subprocess.Popen(
        [sys.executable, "-m", "xgboost_tpu_torch", sub, run], cwd=tmp,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for sub in ("serve-report", "obs-report")}
    outs = {sub: p.communicate(timeout=300) + (p.returncode,)
            for sub, p in reports.items()}
    text, err, rc = outs["serve-report"]
    check(rc == 0, f"fleet: serve-report exit {rc}: {err[-2000:]}")
    check(text.startswith("fleet serve-report (2 replicas)")
          and "per-replica rollup" in text and "server_drain" in text
          and "per-tenant rollup" in text,
          f"fleet: serve-report text: {text[:2000]}")
    with open(os.path.join(run, "obs", "fleet_serve_report.json")) as f:
        doc = json.load(f)
    events = obs_trace.load_trace(
        os.path.join(run, "obs", "fleet_serve.trace.json"))
    check({e.get("pid") for e in events} == {0, 1},
          "fleet: the merged serving trace holds both replicas")
    obs_text, obs_err, rc = outs["obs-report"]
    check(rc == 0 and "obs-report: 2 rank(s)" in obs_text
          and "replica0" in obs_text and "replica1" in obs_text,
          f"fleet: obs-report: {obs_text[:1500]} {obs_err[-1500:]}")
    out["report"] = dict(
        replicas={r["replica"]: {k: r[k] for k in (
            "requests", "ok", "shed", "error", "total_p50_s",
            "total_p99_s", "events")} for r in doc["replicas"]},
        summary={k: doc["summary"][k] for k in (
            "requests", "outcomes", "dispatches", "coalesce_ratio",
            "routes", "cache_misses")},
        tenants=sorted(doc["tenants"]))
    print("fleet: (f) serve-report: " + text.splitlines()[0] + "; "
          + "; ".join(f"{name} total p50 {r['total_p50_s'] * 1e3:.3f} ms "
                      f"p99 {r['total_p99_s'] * 1e3:.3f} ms, events "
                      f"{r['events']}"
                      for name, r in out["report"]["replicas"].items())
          + f"; tenants {out['report']['tenants']}; obs-report folds in "
          "replica0 and replica1")
    shutil.rmtree(tmp, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"fleet: phase {out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 49: the pipelined round loop
# ---------------------------------------------------------------------------

PIPE_ROUNDS = 20        # consumer-free rounds of each run of (a)
PIPE_TURNS = (0, 2, 2, 0, 0, 2)  # XGBTPU_PIPELINE_DEPTH of (a)'s runs
PIPE_CKPT_ROUNDS = 10   # (b) and (c): one checkpoint a round
PIPE_FAULT_ROUND = 5    # (b): the pipeline_sync fault's round
PIPE_CKPT_TURNS = ("1", "0", "0", "1")  # XGBTPU_ASYNC_CKPT of (c)'s runs


def _pipe_syncs(d):
    """The host syncs of one consumer-free round (round 2 of a Booster
    admitting each round to a depth-2 ``RoundPipeline``), listed by
    ``torch.cuda.set_sync_debug_mode("warn")``: ``{"file:line": count}``
    and the first message."""
    from xgboost_tpu_torch.pipeline import RoundPipeline, completion_probe

    bst = xgbt.Booster(PARAMS, cache=[d], device=DEVICE)
    pipe = RoundPipeline(depth=2)
    root = os.path.dirname(os.path.abspath(__file__)) + os.sep
    where, first = {}, None
    for i in range(3):
        if i == 2:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                bst.update(d, i)
                pipe.admit(i, completion_probe(bst._caches[id(d)].margin))
        finally:
            torch.cuda.set_sync_debug_mode(0)
        if i == 2:
            for w in caught:
                if "synchroniz" not in str(w.message):
                    continue
                key = f"{w.filename.replace(root, '')}:{w.lineno}"
                where[key] = where.get(key, 0) + 1
                first = first or str(w.message).splitlines()[0][:160]
    pipe.drain()
    del bst
    return where, first


def phase_pipeline(Xtr, ytr, Xte, yte):
    """Phase 49: the pipelined round loop on the main path (module
    docstring, 49)."""
    from xgboost_tpu_torch.observability import flight
    from xgboost_tpu_torch.resilience import chaos, checkpoint
    from xgboost_tpu_torch.resilience.chaos import ChaosError

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="xgbt_pipeline_")
    env0 = {k: os.environ.get(k) for k in (
        "XGBTPU_PIPELINE_DEPTH", "XGBTPU_ASYNC_CKPT", "XGBTPU_OBSERVER")}
    out = {}
    try:
        d = xgbt.DMatrix(Xtr, ytr, device=DEVICE)
        dv = xgbt.DMatrix(Xte, yte, device=DEVICE)

        # (a) consumer-free rounds at depth 0 and 2, in turns; the first
        # round (binning, kernel C's one-hot) runs before them, untimed
        torch.cuda.synchronize()
        reset_launches()
        xgbt.train(PARAMS, d, 1, verbose_eval=False)
        raws, ms, mem, sync = set(), {0: [], 2: []}, {0: [], 2: []}, \
            {0: 0.0, 2: 0.0}
        for depth in PIPE_TURNS:
            os.environ["XGBTPU_PIPELINE_DEPTH"] = str(depth)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            s0 = flight.stage_totals().get("sync", 0.0)
            t0 = time.perf_counter()
            bst = xgbt.train(PARAMS, d, PIPE_ROUNDS, verbose_eval=False)
            torch.cuda.synchronize()
            ms[depth].append((time.perf_counter() - t0) * 1e3 / PIPE_ROUNDS)
            mem[depth].append(torch.cuda.max_memory_allocated())
            sync[depth] += flight.stage_totals().get("sync", 0.0) - s0
            raws.add(bst.save_raw())
            del bst
        got_a = launches()
        check(len(raws) == 1, "pipeline (a): depths 0 and 2 give equal "
              f"save_raw() bytes ({len(raws)} distinct)")
        check(sync[2] > 0, f"pipeline (a): the flight sync stage at depth 2 "
              f"{sync[2]}")
        want = {"A": 0, "B": 0, "C": 1,
                "D": DEPTH * (1 + PIPE_ROUNDS * len(PIPE_TURNS))}
        check(got_a == want, f"pipeline (a): launches {got_a}, want {want}")
        os.environ["XGBTPU_PIPELINE_DEPTH"] = "2"
        where, first = _pipe_syncs(d)
        out["a"] = dict(
            ms_per_round={k: statistics.median(v) for k, v in ms.items()},
            ms_runs=ms, max_memory_allocated=mem, sync_s=sync,
            launches=got_a, syncs_in_a_round=where, sync_message=first)
        print(f"pipeline: (a) {PIPE_ROUNDS} consumer-free rounds x "
              f"{len(PIPE_TURNS)} runs (depths {PIPE_TURNS}): bytes equal; "
              f"host ms a round, median of 3: depth 0 "
              f"{out['a']['ms_per_round'][0]:.3f}, depth 2 "
              f"{out['a']['ms_per_round'][2]:.3f} (runs {ms}); "
              f"max_memory_allocated depth 0 {max(mem[0])}, depth 2 "
              f"{max(mem[2])} bytes; sync stage {sync} s; launches {got_a}")
        print(f"pipeline: syncs in one consumer-free round "
              f"(set_sync_debug_mode warn): {sum(where.values())} at "
              f"{json.dumps(where)}; first: {first}")

        # (c) async and synchronous checkpoints a round, in turns, each
        # run with the held-out eval (one kernel B walk a round)
        reset_launches()
        files, round_ms, save_ms = {}, {"1": [], "0": []}, {"1": [], "0": []}
        stages = {"1": {}, "0": {}}
        straight = set()
        for i, mode in enumerate(PIPE_CKPT_TURNS):
            os.environ["XGBTPU_ASYNC_CKPT"] = mode
            ckdir = os.path.join(tmp, f"ck_c{i}")
            flight.RECORDER.reset()
            with _ResumeClock() as clock:
                bst = xgbt.train(PARAMS, d, PIPE_CKPT_ROUNDS,
                                 evals=[(dv, "eval")], verbose_eval=False,
                                 resume_from=ckdir, checkpoint_interval=1)
            torch.cuda.synchronize()
            recs = [r for r in flight.RECORDER.records()
                    if r.get("t") == "round"]
            round_ms[mode].append(_median_wall(recs))
            save_ms[mode].append(statistics.median(clock.ms["save"]))
            for st in ("checkpoint", "checkpoint_io", "sync"):
                stages[mode].setdefault(st, []).append(
                    flight.stage_totals().get(st, 0.0))
            straight.add(bst.save_raw())
            del bst
            files[i] = {os.path.basename(p): open(p, "rb").read()
                        for p in checkpoint.list_checkpoints(ckdir)}
        os.environ["XGBTPU_ASYNC_CKPT"] = "1"
        check(len(straight) == 1, "pipeline (c): the runs' bytes are equal")
        S = straight.pop()
        check(all(files[i] == files[0] for i in files) and sorted(files[0])
              == [f"ckpt_{PIPE_CKPT_ROUNDS - 1:08d}.ckpt",
                  f"ckpt_{PIPE_CKPT_ROUNDS:08d}.ckpt"],
              "pipeline (c): async and synchronous checkpoint files "
              "byte-equal")
        check(checkpoint.read_checkpoint(os.path.join(
            tmp, "ck_c0", f"ckpt_{PIPE_CKPT_ROUNDS:08d}.ckpt"))[0] == S,
            "pipeline (c): the newest checkpoint holds the run's bytes")
        out["c"] = dict(median_round_ms=round_ms, save_ms=save_ms,
                        stage_totals_s=stages, payload_bytes=len(S))
        print(f"pipeline: (c) {PIPE_CKPT_ROUNDS} rounds with a checkpoint a "
              f"round and the eval, in turns {PIPE_CKPT_TURNS} "
              f"(XGBTPU_ASYNC_CKPT): files byte-equal; median round ms "
              f"async {round_ms['1']}, sync {round_ms['0']}; a checkpoint "
              f"on the loop's thread ms async {save_ms['1']}, sync "
              f"{save_ms['0']}; stage "
              f"totals s {json.dumps(stages)}; payload {len(S)} bytes")

        # (b) a pipeline_sync fault at round PIPE_FAULT_ROUND's wait, the
        # abort's commit, and the resume
        ckdir = os.path.join(tmp, "ck_b")
        flight.RECORDER.reset()
        err = None
        with chaos.configure(
                f"pipeline_sync:transient:{PIPE_FAULT_ROUND + 1}") as plan:
            try:
                xgbt.train(PARAMS, d, PIPE_CKPT_ROUNDS, evals=[(dv, "eval")],
                           verbose_eval=False, resume_from=ckdir,
                           checkpoint_interval=1)
            except ChaosError as e:
                err = e
        check(err is not None and plan.fired == [
            ("pipeline_sync", PIPE_FAULT_ROUND + 1, "transient")],
            f"pipeline (b): the pipeline_sync fault fired ({plan.fired})")
        check(getattr(err, "pipeline_round", None) == PIPE_FAULT_ROUND,
              f"pipeline (b): .pipeline_round "
              f"{getattr(err, 'pipeline_round', None)}")
        ev = [r for r in flight.RECORDER.records()
              if r.get("t") == "event" and r.get("name") == "pipeline_fault"]
        check(len(ev) == 1 and ev[0]["args"]["round"] == PIPE_FAULT_ROUND,
              f"pipeline (b): pipeline_fault events {ev}")
        at_fault = checkpoint.load_latest(ckdir)[1]
        check(at_fault == PIPE_FAULT_ROUND + 1,
              f"pipeline (b): the abort committed {at_fault} rounds")
        bst = xgbt.train(PARAMS, d, PIPE_CKPT_ROUNDS, evals=[(dv, "eval")],
                         verbose_eval=False, resume_from=ckdir,
                         checkpoint_interval=1)
        check(bst.save_raw() == S, "pipeline (b): resumed == straight")
        del bst
        got_bc = launches()
        resumed = PIPE_CKPT_ROUNDS - at_fault
        evals = PIPE_CKPT_ROUNDS * len(PIPE_CKPT_TURNS) \
            + PIPE_FAULT_ROUND + resumed
        want = {"A": 0, "C": 0,
                "D": DEPTH * (PIPE_CKPT_ROUNDS * (len(PIPE_CKPT_TURNS) + 1)),
                "B": evals + 2 * at_fault}
        check(got_bc == want,
              f"pipeline (b, c): launches {got_bc}, want {want}")
        out["b"] = dict(pipeline_round=err.pipeline_round, at_fault=at_fault,
                        launches_b_c=got_bc)
        print(f"pipeline: (b) pipeline_sync fault at round "
              f"{err.pipeline_round} ({type(err).__name__}, one "
              f"pipeline_fault event), the abort committed {at_fault} "
              f"rounds, resumed == straight; launches of (b) and (c) "
              f"{got_bc} (B: {evals} eval walks, {2 * at_fault} fill walks)")

        # (d) the observer on 2 rounds
        obs = os.path.join(tmp, "obs")
        os.environ["XGBTPU_OBSERVER"] = obs
        xgbt.train(PARAMS, d, 2, verbose_eval=False)
        del os.environ["XGBTPU_OBSERVER"]
        names = sorted(os.listdir(obs))
        want_names = [f"{i:05d}_{n}.npy" for i in (0, 1)
                      for n in ("grad", "hess", "margin")]
        check(names == want_names, f"pipeline (d): observer files {names}")
        sums = {n: float(np.load(os.path.join(obs, n)).astype(np.float64)
                         .sum()) for n in names}
        shapes = {n: list(np.load(os.path.join(obs, n)).shape)
                  for n in names}
        check(all(np.isfinite(v) for v in sums.values())
              and shapes["00000_margin.npy"] == [ROWS, 1]
              and shapes["00000_grad.npy"] == [ROWS],
              f"pipeline (d): observer arrays {shapes} {sums}")
        out["d"] = dict(files=names, sums=sums)
        print(f"pipeline: (d) XGBTPU_OBSERVER on 2 rounds: {names}; sums "
              f"{json.dumps(sums)}")
    finally:
        for k, v in env0.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    out["launches"] = {k: out["a"]["launches"][k] + out["b"]["launches_b_c"][k]
                       for k in "ABCD"}
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"pipeline: launches {out['launches']}; phase "
          f"{out['phase_s']:.1f} s")
    return out



# ---------------------------------------------------------------------------
# phase 50: the C API and the native host runtime
# ---------------------------------------------------------------------------

#: a C program training through libxgbtpu_torch: argv = directory of the
#: raw float32 files (train_X, train_y, test_X, test_y), rows, columns,
#: eval rows, rounds, then key=value parameters; it writes the eval set's
#: predictions (c_pred.f32) and the model (c_model.json) to the directory
C_HOST_TRAIN = r"""
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <math.h>
#include <time.h>

typedef unsigned long long bst_ulong;
extern const char *XGBGetLastError(void);
extern int XGDMatrixCreateFromMat(const float*, bst_ulong, bst_ulong, float,
                                  void**);
extern int XGDMatrixSetFloatInfo(void*, const char*, const float*,
                                 bst_ulong);
extern int XGDMatrixFree(void*);
extern int XGBoosterCreate(void**, bst_ulong, void**);
extern int XGBoosterSetParam(void*, const char*, const char*);
extern int XGBoosterUpdateOneIter(void*, int, void*);
extern int XGBoosterEvalOneIter(void*, int, void**, const char**, bst_ulong,
                                const char**);
extern int XGBoosterPredict(void*, void*, int, unsigned, int, bst_ulong*,
                            const float**);
extern int XGBoosterSaveModelToBuffer(void*, const char*, bst_ulong*,
                                      const char**);
extern int XGBoosterFree(void*);

#define CK(x) if ((x) != 0) { \
  fprintf(stderr, "FAIL %s: %s\n", #x, XGBGetLastError()); return 1; }

static double now(void) {
  struct timespec t;
  clock_gettime(CLOCK_MONOTONIC, &t);
  return t.tv_sec + 1e-9 * t.tv_nsec;
}

static float *load(const char *dir, const char *name, size_t n) {
  char path[4096];
  snprintf(path, sizeof path, "%s/%s.f32", dir, name);
  FILE *f = fopen(path, "rb");
  float *buf = malloc(n * sizeof(float));
  if (!f || !buf || fread(buf, sizeof(float), n, f) != n) return NULL;
  fclose(f);
  return buf;
}

static int save(const char *dir, const char *name, const void *p, size_t n) {
  char path[4096];
  snprintf(path, sizeof path, "%s/%s", dir, name);
  FILE *f = fopen(path, "wb");
  if (!f || fwrite(p, 1, n, f) != n) return 1;
  return fclose(f);
}

int main(int argc, char **argv) {
  double t0 = now();
  if (argc < 6) return 2;
  const char *dir = argv[1];
  size_t rows = atol(argv[2]), cols = atol(argv[3]), erows = atol(argv[4]);
  int rounds = atoi(argv[5]);
  float *X = load(dir, "train_X", rows * cols), *y = load(dir, "train_y", rows);
  float *Xe = load(dir, "test_X", erows * cols), *ye = load(dir, "test_y", erows);
  if (!X || !y || !Xe || !ye) { fprintf(stderr, "FAIL: read\n"); return 1; }
  double t_read = now() - t0;
  void *dtr = NULL, *dte = NULL, *bst = NULL;
  CK(XGDMatrixCreateFromMat(X, rows, cols, NAN, &dtr));
  double t_handle = now() - t0;
  CK(XGDMatrixSetFloatInfo(dtr, "label", y, rows));
  CK(XGDMatrixCreateFromMat(Xe, erows, cols, NAN, &dte));
  CK(XGDMatrixSetFloatInfo(dte, "label", ye, erows));
  void *mats[2] = {dtr, dte};
  CK(XGBoosterCreate(mats, 2, &bst));
  for (int i = 6; i < argc; ++i) {
    char *eq = strchr(argv[i], '=');
    if (!eq) return 2;
    *eq = '\0';
    CK(XGBoosterSetParam(bst, argv[i], eq + 1));
  }
  void *evm[1] = {dte};
  const char *names[1] = {"test"};
  const char *res = NULL;
  printf("C_HOST_READ_S=%.3f\nC_HOST_FIRST_HANDLE_S=%.3f\nC_HOST_ROUND_MS=",
         t_read, t_handle);
  double t_first = 0;
  for (int it = 0; it < rounds; ++it) {
    double t = now();
    CK(XGBoosterUpdateOneIter(bst, it, dtr));
    CK(XGBoosterEvalOneIter(bst, it, evm, names, 1, &res));
    printf("%s%.3f", it ? "," : "", (now() - t) * 1e3);
    if (it == 0) t_first = now() - t0;
  }
  printf("\nC_HOST_FIRST_ROUND_S=%.3f\nC_HOST_EVAL=%s\n", t_first, res);
  bst_ulong len = 0;
  const float *out = NULL;
  CK(XGBoosterPredict(bst, dte, 0, 0, 0, &len, &out));
  if (len != erows || save(dir, "c_pred.f32", out, len * sizeof(float)))
    return 1;
  const char *model = NULL;
  CK(XGBoosterSaveModelToBuffer(bst, "{}", &len, &model));
  if (save(dir, "c_model.json", model, len)) return 1;
  CK(XGBoosterFree(bst));
  CK(XGDMatrixFree(dte));
  CK(XGDMatrixFree(dtr));
  printf("C_HOST_TOTAL_S=%.3f\n", now() - t0);
  return 0;
}
"""


def _capi(path):
    """The C API library through ``ctypes``, the entry points the phase
    calls typed."""
    import ctypes as C

    VP, U64, F32P = C.c_void_p, C.c_uint64, C.POINTER(C.c_float)
    sig = {
        "XGDMatrixCreateFromMat": [F32P, U64, U64, C.c_float,
                                   C.POINTER(VP)],
        "XGDMatrixCreateFromFile": [C.c_char_p, C.c_int, C.POINTER(VP)],
        "XGDMatrixSetFloatInfo": [VP, C.c_char_p, F32P, U64],
        "XGDMatrixGetFloatInfo": [VP, C.c_char_p, C.POINTER(U64),
                                  C.POINTER(F32P)],
        "XGDMatrixNumRow": [VP, C.POINTER(U64)],
        "XGDMatrixNumCol": [VP, C.POINTER(U64)],
        "XGDMatrixFree": [VP],
        "XGBoosterCreate": [C.POINTER(VP), U64, C.POINTER(VP)],
        "XGBoosterSetParam": [VP, C.c_char_p, C.c_char_p],
        "XGBoosterUpdateOneIter": [VP, C.c_int, VP],
        "XGBoosterEvalOneIter": [VP, C.c_int, C.POINTER(VP),
                                 C.POINTER(C.c_char_p), U64,
                                 C.POINTER(C.c_char_p)],
        "XGBoosterPredict": [VP, VP, C.c_int, C.c_uint, C.c_int,
                             C.POINTER(U64), C.POINTER(F32P)],
        "XGBoosterSaveModelToBuffer": [VP, C.c_char_p, C.POINTER(U64),
                                       C.POINTER(C.c_char_p)],
        "XGBoosterFree": [VP],
    }
    lib = C.CDLL(path)
    lib.XGBGetLastError.restype = C.c_char_p
    for name, argtypes in sig.items():
        getattr(lib, name).argtypes = argtypes

    def ok(rc, what):
        check(rc == 0, f"c api: {what} returned {rc}: "
              f"{lib.XGBGetLastError().decode()}")

    def dmatrix(X, y):
        X = np.ascontiguousarray(X, np.float32)
        y = np.ascontiguousarray(y, np.float32)
        h = VP()
        ok(lib.XGDMatrixCreateFromMat(X.ctypes.data_as(F32P), X.shape[0],
                                      X.shape[1], float("nan"),
                                      C.byref(h)), "XGDMatrixCreateFromMat")
        ok(lib.XGDMatrixSetFloatInfo(h, b"label", y.ctypes.data_as(F32P),
                                     y.size), "XGDMatrixSetFloatInfo")
        return h

    def predict(bh, h):
        n, p = U64(), F32P()
        ok(lib.XGBoosterPredict(bh, h, 0, 0, 0, C.byref(n), C.byref(p)),
           "XGBoosterPredict")
        return np.ctypeslib.as_array(p, shape=(n.value,)).copy()

    def raw(bh):
        n, p = U64(), C.c_char_p()
        ok(lib.XGBoosterSaveModelToBuffer(bh, b"{}", C.byref(n), C.byref(p)),
           "XGBoosterSaveModelToBuffer")
        return C.string_at(p, n.value)

    lib.ok, lib.dmatrix, lib.predict, lib.raw = ok, dmatrix, predict, raw
    lib.C = C
    return lib


def _param_pairs(params):
    """``params`` as ``XGBoosterSetParam`` calls: one a key, one a metric
    for a list (each call adds a metric)."""
    for k, v in params.items():
        for item in (v if isinstance(v, list) else [v]):
            yield k, str(item)


def _eval_values(text):
    """``{"test-auc": x, ...}`` of an ``EvalOneIter`` string."""
    return {k: float(v) for k, v in
            (f.rsplit(":", 1) for f in text.split("\t")[1:])}


def phase_c_api(Xtr, ytr, Xte, yte, extmem=None):
    """Phase 50: the C API and the native host runtime on the card
    (module docstring, 50)."""
    from xgboost_tpu_torch import native
    from xgboost_tpu_torch.data import adapters

    t_phase = time.perf_counter()
    out = {}
    # (a) the three native libraries, built in turn
    t0 = time.perf_counter()
    paths = {n: str(native.build(n)) for n in ("fastparse", "pagecache",
                                               "capi")}
    out["build_s"] = time.perf_counter() - t0
    out["builds"] = {n: native.build_log[n]["seconds"] for n in paths}
    print(f"c api: (a) native builds {out['build_s']:.2f} s "
          f"({json.dumps(out['builds'])}); libraries {json.dumps(paths)}")
    env0 = os.environ.pop("XGBTPU_DEVICE", None)  # unset: the card
    tmp = tempfile.mkdtemp(prefix="xgbt_capi_")
    try:
        lib = _capi(paths["capi"])
        C = lib.C

        # (b) in process through ctypes, in turns with the Python API
        h_tr, h_te = lib.dmatrix(Xtr, ytr), lib.dmatrix(Xte, yte)
        bh = C.c_void_p()
        lib.ok(lib.XGBoosterCreate((C.c_void_p * 2)(h_tr, h_te), 2,
                                   C.byref(bh)), "XGBoosterCreate")
        for k, v in _param_pairs(PARAMS):
            lib.ok(lib.XGBoosterSetParam(bh, k.encode(), v.encode()),
                   f"XGBoosterSetParam({k}, {v})")
        d_tr, d_te = xgbt.DMatrix(Xtr, ytr), xgbt.DMatrix(Xte, yte)
        bp = xgbt.Booster(PARAMS, [d_tr, d_te])
        evm = (C.c_void_p * 1)(h_te)
        names = (C.c_char_p * 1)(b"test")
        res = C.c_char_p()
        got = {k: 0 for k in "ABCD"}
        ms = {"c_api": [], "python": []}
        evals = {"c_api": [], "python": []}

        def c_round(it):
            before = launches()
            lib.ok(lib.XGBoosterUpdateOneIter(bh, it, h_tr),
                   "XGBoosterUpdateOneIter")
            lib.ok(lib.XGBoosterEvalOneIter(bh, it, evm, names, 1,
                                            C.byref(res)),
                   "XGBoosterEvalOneIter")
            evals["c_api"].append(res.value.decode())
            for k, v in launches().items():
                got[k] += v - before[k]

        def py_round(it):
            bp.update(d_tr, it)
            evals["python"].append(bp.eval_set([(d_te, "test")], it))

        reset_launches()
        for it in range(ROUNDS):
            turn = (("c_api", c_round), ("python", py_round))
            for name, fn in (turn if it % 2 == 0 else turn[::-1]):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn(it)
                torch.cuda.synchronize()
                ms[name].append((time.perf_counter() - t0) * 1e3)
        before = launches()
        pred_c = lib.predict(bh, h_te)
        for k, v in launches().items():
            got[k] += v - before[k]
        raw_c = lib.raw(bh)
        pred_p = bp.predict(d_te)
        check(raw_c == bp.save_raw(),
              "c api (b): model bytes == the Python API's")
        check(pred_c.dtype == pred_p.dtype
              and np.array_equal(pred_c, pred_p),
              "c api (b): predictions == the Python API's, bit for bit")
        check(evals["c_api"] == evals["python"],
              f"c api (b): eval strings {evals['c_api'][-1]} vs "
              f"{evals['python'][-1]}")
        auc = [_eval_values(e)["test-auc"] for e in evals["c_api"]]
        check(auc[-1] >= 0.80 and auc[-1] > auc[0],
              f"c api (b): held-out AUC {auc}")
        want = {"A": 0, "C": 1, "D": ROUNDS * DEPTH}
        check(all(got[k] == v for k, v in want.items())
              and got["B"] >= ROUNDS,
              f"c api (b): launches {got}, want {want} and B >= {ROUNDS}")
        out["b"] = dict(launches=got, ms=ms,
                        median_ms={k: statistics.median(v)
                                   for k, v in ms.items()},
                        auc=auc, eval_last=evals["c_api"][-1])
        print(f"c api: (b) {ROUNDS} rounds through ctypes and the Python "
              f"API in turns: bytes, predictions and eval strings equal; "
              f"launches through the C API {got}; ms a round (update + "
              f"eval, median) C API {out['b']['median_ms']['c_api']:.2f}, "
              f"Python {out['b']['median_ms']['python']:.2f} (C API "
              f"{[round(v, 2) for v in ms['c_api']]}, Python "
              f"{[round(v, 2) for v in ms['python']]}); "
              f"{evals['c_api'][-1]!r}")
        del bp, d_tr, d_te
        for h in (h_tr, h_te):
            lib.ok(lib.XGDMatrixFree(h), "XGDMatrixFree")
        torch.cuda.empty_cache()

        # (c) a C program on the card
        for name, arr in (("train_X", Xtr), ("train_y", ytr),
                          ("test_X", Xte), ("test_y", yte)):
            np.ascontiguousarray(arr, np.float32).tofile(
                os.path.join(tmp, f"{name}.f32"))
        lib_path = paths["capi"]
        src, exe = os.path.join(tmp, "host.c"), os.path.join(tmp, "host")
        with open(src, "w") as f:
            f.write(C_HOST_TRAIN)
        cc = subprocess.run(
            ["gcc", "-O2", src, "-o", exe,
             f"-L{os.path.dirname(lib_path)}",
             f"-l:{os.path.basename(lib_path)}",
             f"-Wl,-rpath,{os.path.dirname(lib_path)}", "-lm"],
            capture_output=True, text=True, timeout=120)
        check(cc.returncode == 0, f"c api (c): gcc: {cc.stderr[-2000:]}")
        args = [exe, tmp, str(len(Xtr)), str(COLS), str(len(Xte)),
                str(ROUNDS)] + [f"{k}={v}" for k, v in _param_pairs(PARAMS)]
        t0 = time.perf_counter()
        host = subprocess.run(args, capture_output=True, text=True,
                              timeout=600)
        host_s = time.perf_counter() - t0
        check(host.returncode == 0,
              f"c api (c): the C host exited {host.returncode}: "
              f"{host.stdout[-2000:]} {host.stderr[-3000:]}")
        lines = dict(ln.split("=", 1) for ln in host.stdout.splitlines()
                     if ln.startswith("C_HOST_"))
        with open(os.path.join(tmp, "c_model.json"), "rb") as f:
            check(f.read() == raw_c,
                  "c api (c): the C host's model bytes == (b)'s")
        host_pred = np.fromfile(os.path.join(tmp, "c_pred.f32"), np.float32)
        check(np.array_equal(host_pred, pred_c),
              "c api (c): the C host's predictions == (b)'s, bit for bit")
        check(lines.get("C_HOST_EVAL") == evals["c_api"][-1],
              f"c api (c): the C host's last eval {lines.get('C_HOST_EVAL')}")
        round_ms = [float(v) for v in lines["C_HOST_ROUND_MS"].split(",")]
        out["c"] = dict(
            exit_code=host.returncode, process_s=host_s,
            read_s=float(lines["C_HOST_READ_S"]),
            first_handle_s=float(lines["C_HOST_FIRST_HANDLE_S"]),
            first_round_s=float(lines["C_HOST_FIRST_ROUND_S"]),
            round_ms=round_ms, median_round_ms=statistics.median(
                round_ms[1:]))
        print(f"c api: (c) C host exit {host.returncode} in {host_s:.2f} s: "
              f"read {out['c']['read_s']:.3f} s, first handle (interpreter, "
              f"torch import, the copy to the card) "
              f"{out['c']['first_handle_s']:.3f} s, first round finished "
              f"{out['c']['first_round_s']:.3f} s after the start; ms a "
              f"round {round_ms} (median of rounds 1-{ROUNDS - 1} "
              f"{out['c']['median_round_ms']:.2f}); model bytes and "
              f"predictions == (b)'s")

        # (d) the parser: XGDMatrixCreateFromFile against the plain parser
        out["d"] = {}
        loaded = xgbt.Booster(model_file=raw_c)
        for name, X, y in (("train", Xtr[:CLI_ROWS], ytr[:CLI_ROWS]),
                           ("test", Xte[:CLI_TEST_ROWS],
                            yte[:CLI_TEST_ROWS])):
            path = os.path.join(tmp, f"{name}.libsvm")
            _write_libsvm(path, X, y)
            h = C.c_void_p()
            t0 = time.perf_counter()
            lib.ok(lib.XGDMatrixCreateFromFile(path.encode(), 1,
                                               C.byref(h)),
                   "XGDMatrixCreateFromFile")
            torch.cuda.synchronize()
            capi_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            Xn, yn, qn = native.load_svmlight_native(path)
            native_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            Xp, yp, qp = adapters._load_svmlight_py(path)
            plain_s = time.perf_counter() - t0
            check(Xn.shape == Xp.shape == X.shape and np.array_equal(
                Xn, Xp) and np.array_equal(yn, yp) and qn is None
                and qp is None and np.array_equal(Xp, X),
                f"c api (d): {name}: the native parser's arrays == the "
                "plain parser's")
            nr, nc = C.c_uint64(), C.c_uint64()
            lib.ok(lib.XGDMatrixNumRow(h, C.byref(nr)), "XGDMatrixNumRow")
            lib.ok(lib.XGDMatrixNumCol(h, C.byref(nc)), "XGDMatrixNumCol")
            n, p = C.c_uint64(), C.POINTER(C.c_float)()
            lib.ok(lib.XGDMatrixGetFloatInfo(h, b"label", C.byref(n),
                                             C.byref(p)),
                   "XGDMatrixGetFloatInfo")
            check((nr.value, nc.value) == Xp.shape and np.array_equal(
                np.ctypeslib.as_array(p, shape=(n.value,)), yp),
                f"c api (d): {name}: the handle's shape and labels")
            check(np.array_equal(lib.predict(bh, h),
                                 loaded.predict(xgbt.DMatrix(Xp))),
                f"c api (d): {name}: predictions on the file's handle == "
                "on the plain parser's rows")
            lib.ok(lib.XGDMatrixFree(h), "XGDMatrixFree")
            out["d"][name] = dict(rows=len(yp), capi_s=capi_s,
                                  native_s=native_s, plain_s=plain_s,
                                  bytes=os.path.getsize(path))
            print(f"c api: (d) {name}.libsvm ({len(yp)} rows, "
                  f"{os.path.getsize(path)} bytes): XGDMatrixCreateFromFile "
                  f"{capi_s:.3f} s (the card's DMatrix included), native "
                  f"parse {native_s:.3f} s, plain Python parse "
                  f"{plain_s:.3f} s; arrays equal")
        lib.ok(lib.XGBoosterFree(bh), "XGBoosterFree")
    finally:
        if env0 is not None:
            os.environ["XGBTPU_DEVICE"] = env0
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()

    # (e) the paged phase's reads, through the native ring since this phase
    if extmem is not None:
        io = extmem["paged"]["io"]
        out["e"] = dict(
            wait_ms_per_page=io["wait_s"] * 1e3 / max(io["prefetched"], 1),
            read_ms_per_page=io["read_s"] * 1e3 / max(io["reads"], 1),
            copy_ms_per_page=statistics.mean(
                p["copy_ms"] for p in extmem["pages"]),
            reads=io["reads"], prefetched=io["prefetched"])
        print(f"c api: (e) the paged phase through pagecache.cpp's ring: "
              f"{io['reads']} page reads ({io['prefetched']} prefetched), "
              f"read wait {out['e']['wait_ms_per_page']:.3f} ms a page "
              f"(numpy reads: ~2.95), pc_read "
              f"{out['e']['read_ms_per_page']:.3f} "
              f"ms a read, copy {out['e']['copy_ms_per_page']:.3f} ms a "
              f"page (numpy reads: 2.5-2.9); paged trees == streaming")
    out["launches"] = out["b"]["launches"]
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"c api: launches {out['launches']}; phase {out['phase_s']:.1f} s")
    return out

# ---------------------------------------------------------------------------
# phase 51: the per-level grow profiler and the perf ledger
# ---------------------------------------------------------------------------

#: (name, parameters, hoist budget env, the level kernel) of phase 51's runs
KP_CONFIGS = (("a_bin64_D", PARAMS, None, "D"),
              ("b_bin64_A", PARAMS, "0", "A"),
              ("c_bin256_D", PARAMS_DEFAULT, None, "D"))
KP_OPS = ("prep", "level_hist", "level_update", "level_partition",
          "finalize", "leaf_delta")


class _SyncWatch(xgbt.callback.TrainingCallback):
    """Lists the host syncs of round ``at`` (``set_sync_debug_mode``:
    warnings caught around the whole run, the mode on for that round
    alone)."""

    def __init__(self, at: int):
        self.at = at

    def before_iteration(self, model, epoch, evals_log):
        if epoch == self.at:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("warn")
        return False

    def after_iteration(self, model, epoch, evals_log):
        torch.cuda.set_sync_debug_mode(0)
        return False


def _train_round_syncs(d, spec):
    """The host syncs of round 2 of a 3-round consumer-free ``train`` (the
    callback above is its only consumer) with ``XGBTPU_KERNEL_PROF`` =
    ``spec`` (None: unset): ``{"file:line": count}``."""
    root = os.path.dirname(os.path.abspath(__file__)) + os.sep
    if spec is None:
        os.environ.pop("XGBTPU_KERNEL_PROF", None)
    else:
        os.environ["XGBTPU_KERNEL_PROF"] = spec
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            try:
                xgbt.train(PARAMS, d, 3, verbose_eval=False,
                           callbacks=[_SyncWatch(2)])
            finally:
                torch.cuda.set_sync_debug_mode(0)
    finally:
        os.environ.pop("XGBTPU_KERNEL_PROF", None)
    where = {}
    for w in caught:
        if "synchroniz" in str(w.message):
            key = f"{w.filename.replace(root, '')}:{w.lineno}"
            where[key] = where.get(key, 0) + 1
    return where


def _kp_run(name, params, Xtr, ytr, Xte, yte, spec, run_dir, inside):
    """One 10-round run of phase 51 on a fresh matrix (its own binning and,
    hoisted, kernel C's one-hot) with the held-out eval, the flight sink at
    ``run_dir``: ``(save_raw bytes, launches, the round records)``."""
    from xgboost_tpu_torch.observability import flight

    if spec is None:
        os.environ.pop("XGBTPU_KERNEL_PROF", None)
    else:
        os.environ["XGBTPU_KERNEL_PROF"] = spec
    flight.RECORDER.reset()
    flight.configure(run_dir, rank=0)
    try:
        d = xgbt.DMatrix(Xtr, ytr, device=DEVICE)
        dv = xgbt.DMatrix(Xte, yte, device=DEVICE)
        torch.cuda.synchronize()
        reset_launches()
        inside.update(B=0, C=0)
        bst = xgbt.train(params, d, ROUNDS, evals=[(dv, "eval")],
                         verbose_eval=False)
        torch.cuda.synchronize()
        got = launches()
        recs = [r for r in flight.RECORDER.records() if r.get("t") == "round"]
        raw = bst.save_raw()
        del bst, d, dv
    finally:
        flight.RECORDER.reset()  # closes the sink
        os.environ.pop("XGBTPU_KERNEL_PROF", None)
    torch.cuda.empty_cache()
    print(f"kernelprof: {name} {'profiled' if spec else 'unprofiled'}: "
          f"launches {got}")
    return raw, got, recs


def _kp_medians(recs):
    """Per (op, depth): the medians over rounds 1-9 (round 0 also bins and
    builds the one-hot) of wall, host, in-flight and gap ms, and its
    impls; per round: the coverage ``sum_s / stages.grow`` and the rest of
    ``stages.grow`` outside the brackets and their gaps."""
    per = {}
    cover, rest_ms, gap_ms, grow_ms = [], [], [], []
    for r in recs:
        gd = r.get("grow_detail")
        if gd is None or r["round"] == 0:
            continue
        for b in gd["ops"]:
            e = per.setdefault(f"{b['op']}@{b['depth']}", {
                "wall": [], "host": [], "inflight": [], "gap": [],
                "impl": set()})
            for k in ("wall", "host", "inflight", "gap"):
                e[k].append(b[f"{k}_s"] * 1e3)
            e["impl"].add(b["impl"])
        grow = r["stages"]["grow"]
        cover.append(gd["sum_s"] / grow)
        grow_ms.append(grow * 1e3)
        gap_ms.append(gd["gap_s"] * 1e3)
        rest_ms.append((grow - gd["sum_s"] - gd["gap_s"]) * 1e3)
    table = {k: dict({m: statistics.median(v[m]) for m in
                      ("wall", "host", "inflight", "gap")},
                     impl=sorted(v["impl"])) for k, v in per.items()}
    return table, dict(
        coverage_median=statistics.median(cover), coverage=cover,
        grow_ms_median=statistics.median(grow_ms),
        gap_ms_median=statistics.median(gap_ms),
        outside_ms_median=statistics.median(rest_ms))


def _report(argv):
    """``python -m xgboost_tpu_torch <argv>`` in this process
    (``cli_main``; ``_cli``'s new process would cost ~8 s a call): its
    exit code and standard output."""
    import io

    from xgboost_tpu_torch import cli as tcli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = tcli.cli_main(list(argv))
    return rc, buf.getvalue()


def phase_kernelprof(Xtr, ytr, Xte, yte, pipe_syncs=None):
    """Phase 51: the per-level grow profiler and the perf ledger on the
    main path (module docstring, 51). ``pipe_syncs``: phase 49's host syncs
    of a consumer-free round, when it ran."""
    from xgboost_tpu_torch.observability import kernelprof as tkp

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="xgbt_kernelprof_")
    env0 = {k: os.environ.get(k) for k in (
        "XGBTPU_KERNEL_PROF", "XGBTPU_HOIST_BUDGET_MB")}
    out = {"runs": {}}
    inside = {"B": 0, "C": 0}
    bracket0 = tkp._bracket

    def counting(prof, device):
        """The profiler's bracket, also counting kernels B and C inside."""
        step = bracket0(prof, device)

        def run(op, depth, fn, *args, **kwargs):
            b0, c0 = predict_margin.launches, hk.build_onehot.launches
            res = step(op, depth, fn, *args, **kwargs)
            inside["B"] += predict_margin.launches - b0
            inside["C"] += hk.build_onehot.launches - c0
            return res
        return run

    tkp._bracket = counting
    try:
        for name, params, budget, kernel in KP_CONFIGS:
            if budget is None:
                os.environ.pop("XGBTPU_HOIST_BUDGET_MB", None)
            else:
                os.environ["XGBTPU_HOIST_BUDGET_MB"] = budget
            runs = {}
            for spec in (None, "every=1"):
                run_dir = os.path.join(tmp, name, spec or "off")
                runs[spec] = _kp_run(name, params, Xtr, ytr, Xte, yte, spec,
                                     run_dir, inside)
            (raw0, l0, recs0), (raw1, l1, recs1) = runs[None], runs["every=1"]
            check(raw1 == raw0, f"kernelprof ({name}): profiled model bytes "
                  "equal the unprofiled run's")
            other = "A" if kernel == "D" else "D"
            want = {kernel: ROUNDS * DEPTH, other: 0, "B": ROUNDS,
                    "C": 1 if kernel == "D" else 0}
            check(l0 == l1 == want, f"kernelprof ({name}): launches "
                  f"unprofiled {l0}, profiled {l1}, want {want}")
            check(inside == {"B": 0, "C": 0}, f"kernelprof ({name}): "
                  f"kernels B and C launched inside a bracket {inside}")
            check(not any("grow_detail" in r for r in recs0),
                  f"kernelprof ({name}): an unprofiled round has a record")
            gds = [r["grow_detail"] for r in recs1]
            check(len(gds) == ROUNDS and all(
                g["host_syncs"] == 4 + 2 * DEPTH and len(g["ops"]) ==
                4 + 2 * DEPTH for g in gds),
                f"kernelprof ({name}): a record a round, "
                f"{4 + 2 * DEPTH} brackets each")
            impls = {(b["op"], b["impl"]) for g in gds for b in g["ops"]}
            want_impls = {(op, f"cuda:{kernel}" if op == "level_hist"
                           else "torch") for op in KP_OPS}
            check(impls == want_impls, f"kernelprof ({name}): impls "
                  f"{sorted(impls)}, want {sorted(want_impls)}")
            table, cover = _kp_medians(recs1)
            grow0 = statistics.median(r["stages"]["grow"] * 1e3
                                      for r in recs0 if r["round"] > 0)
            qs = gds[-1]["quant_scales"]
            out["runs"][name] = dict(launches=l1, launches_unprofiled=l0,
                                     ops=table, quant_scales=qs,
                                     grow_ms_unprofiled_median=grow0,
                                     **cover)
            print(f"kernelprof: ({name}) bytes equal; level_hist "
                  f"cuda:{kernel}; launches {l1} both; B and C inside the "
                  f"brackets {inside}; quant_scales of round 9 {qs}")
            print(f"kernelprof: ({name}) coverage sum_s / stages.grow, "
                  f"rounds 1-9: median {cover['coverage_median']:.4f} "
                  f"({', '.join(f'{c:.3f}' for c in cover['coverage'])}); "
                  f"stages.grow {cover['grow_ms_median']:.3f} ms "
                  f"(unprofiled {grow0:.3f}), gaps "
                  f"{cover['gap_ms_median']:.3f} ms, outside the brackets "
                  f"{cover['outside_ms_median']:.3f} ms (medians)")
            print(f"kernelprof: ({name}) per op and depth, medians of rounds "
                  f"1-9, ms: wall / host / in-flight / gap")
            for key in sorted(table, key=lambda k: (int(k.split("@")[1]),
                                                    k)):
                m = table[key]
                print(f"  {key:<20} {m['impl'][0]:<7} {m['wall']:9.4f} "
                      f"{m['host']:9.4f} {m['inflight']:9.4f} "
                      f"{m['gap']:9.4f}")
            os.environ.pop("XGBTPU_HOIST_BUDGET_MB", None)

        # (d) grow-report, trace-report and perf-report on this run's sinks
        # and the repository's banks
        a_dir = os.path.join(tmp, "a_bin64_D", "every=1")
        b_dir = os.path.join(tmp, "b_bin64_A", "every=1")
        rc, text = _report(["grow-report", a_dir])
        check(rc == 0 and text.count("grow detail") == ROUNDS
              and "cuda:D" in text and "substages = " in text,
              f"kernelprof (d): grow-report rc {rc}")
        rc_d, diff = _report(["grow-report", "--diff", a_dir, b_dir])
        check(rc_d == 0 and "cuda:D->cuda:A" in diff,
              f"kernelprof (d): grow-report --diff rc {rc_d}")
        trace_file = os.path.join(a_dir, "obs", "rank0", "trace.jsonl")
        rc_t, ttext = _report(["trace-report", trace_file])
        check(rc_t == 0 and "grow breakdown" in ttext
              and "grow/level_hist" in ttext,
              f"kernelprof (d): trace-report rc {rc_t}")
        root = os.path.dirname(os.path.abspath(__file__))
        rc_p, ptext = _report(["perf-report", "--root", root])
        check(rc_p == 0 and ptext.startswith("== perf ledger:"),
              f"kernelprof (d): perf-report rc {rc_p}")
        print("kernelprof: (d) grow-report of (a), round 5:\n" + "\n".join(
            text.split("\n\n")[5].splitlines()))
        print("kernelprof: (d) grow-report --diff (a) (b):\n" + diff.rstrip())
        print("kernelprof: (d) trace-report of (a): " + " | ".join(
            ln.strip() for ln in ttext.splitlines() if "grow" in ln)[:1500])
        print(f"kernelprof: (d) perf-report --root .: exit 0, "
              f"{ptext.splitlines()[0]}")
        out["reports"] = dict(grow_report=rc, diff=rc_d, trace_report=rc_t,
                              perf_report=rc_p)

        # (e) an unprofiled round keeps the host syncs it had
        d = xgbt.DMatrix(Xtr, ytr, device=DEVICE)
        where49 = pipe_syncs if pipe_syncs is not None else _pipe_syncs(d)[0]
        off = _train_round_syncs(d, None)
        between = _train_round_syncs(d, "rounds=0,1")
        del d
        check(between == off, f"kernelprof (e): host syncs of an unprofiled "
              f"round after two profiled ones {between}, with the profiler "
              f"off {off}")
        check(set(where49) <= set(off), f"kernelprof (e): phase 49's syncs "
              f"{where49} not all in a train round's {off}")
        out["syncs"] = dict(phase49=where49, train_off=off,
                            train_after_profiled=between)
        print(f"kernelprof: (e) host syncs of an unprofiled round: phase 49's "
              f"harness {json.dumps(where49)}; train round 2, profiler off "
              f"{json.dumps(off)}, after profiled rounds 0-1 "
              f"{json.dumps(between)}")
    finally:
        tkp._bracket = bracket0
        for k, v in env0.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    out["launches"] = {k: sum(r["launches"][k] for r in out["runs"].values())
                       for k in "ABCD"}
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"kernelprof: launches of the profiled runs {out['launches']}; "
          f"phase {out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 52: kernel S, the strict-order scan of split evaluation
# ---------------------------------------------------------------------------

#: the benchmark cell whose rows phase 52 trains on, and its seed
SCAN_CELL, SCAN_SEED = "synth-binary.1m-bin256", 2_900_000_017


def _scan_level_shapes():
    """``[2, K, F, 256]``, the shapes of a level's two scans on the main
    path: depths 0-5 at F = 50 (the binary cell) and F = 136 (ranking)."""
    return [(2, 1 << d, F, DEFAULT_MAX_BIN) for F in (COLS, 136)
            for d in range(DEPTH)]


class _RoundClock(xgbt.callback.TrainingCallback):
    """Syncs and reads the clock once, after round 0, so that the caller's
    synced end over ``rounds - 1`` is the warm rounds' wall a round."""

    def after_iteration(self, model, epoch, evals_log):
        if epoch == 0:
            torch.cuda.synchronize()
            self.t0 = time.perf_counter()
        return False


def _scan_train(dtrain, dvalid, params, rounds, spec=None, run_dir=None):
    """One ``train`` of ``rounds`` on the cell's matrices:
    ``(save_raw bytes, kernel S launches, ms a round after round 0, round
    records)``; with ``spec``, under ``XGBTPU_KERNEL_PROF`` and the flight
    sink at ``run_dir``."""
    from xgboost_tpu_torch.observability import flight
    from xgboost_tpu_torch.tree import grow as tgrow

    if spec is not None:
        os.environ["XGBTPU_KERNEL_PROF"] = spec
        flight.RECORDER.reset()
        flight.configure(run_dir, rank=0)
    clock = _RoundClock()
    try:
        s0 = tgrow.seq_cumsum.launches
        bst = xgbt.train(params, dtrain, rounds, evals=[(dvalid, "valid")],
                         verbose_eval=False, callbacks=[clock])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - clock.t0) / (rounds - 1) * 1e3
        got = tgrow.seq_cumsum.launches - s0
        recs = [r for r in flight.RECORDER.records() if r.get("t") == "round"]
        raw = bst.save_raw()
        del bst
    finally:
        if spec is not None:
            flight.RECORDER.reset()
            os.environ.pop("XGBTPU_KERNEL_PROF", None)
    return raw, got, ms, recs


def phase_scan():
    """Phase 52: kernel S against the plain loop, timed at the main path's
    level shapes, and on the binary benchmark cell's rows (module
    docstring, 52)."""
    from portbench import harness, traffic
    from xgboost_tpu_torch.tree import grow as tgrow

    t_phase = time.perf_counter()
    out = {"levels": [], "widths": []}
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(52)
    # (a) the main path's level shapes, and the other widths
    for shape in _scan_level_shapes() + [(2, 4, 54, 7175), (2, 2, 8, 16001)]:
        x = torch.randn(shape, generator=gen, device=DEVICE)
        got = tgrow.seq_cumsum(x)
        want = tgrow._seq_cumsum_plain(x)
        torch.cuda.synchronize()
        check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
              f"scan {shape}: kernel S == the plain loop, bit for bit")
        del got, want
        B = shape[-1]
        ms = time_ms(lambda: tgrow.seq_cumsum(x))
        k_ms = kernel_ms(lambda: tgrow.seq_cumsum(x), "S")
        plain_ms = time_ms(lambda: tgrow._seq_cumsum_plain(x), reps=5,
                           warmup=1)
        lib_ms = time_ms(lambda: torch.cumsum(x, -1))
        bnd, by = bound_ms(2 * x.numel() * 4, x.numel())
        rec = dict(shape=list(shape), rows=x.numel() // B, ms=ms,
                   kernel_ms=k_ms, plain_ms=plain_ms, library_ms=lib_ms,
                   bound_ms=bnd, bound_by=by)
        (out["levels"] if B == DEFAULT_MAX_BIN else out["widths"]).append(rec)
        print(f"kernel S {shape}: {ms:.4f} ms (kernel alone {k_ms} ms)  "
              f"plain {plain_ms:.4f} ms  torch.cumsum {lib_ms:.4f} ms  "
              f"bound {bnd:.5f} ms ({by})  bitwise equal")
        del x
    for F in (COLS, 136):
        lv = [r for r in out["levels"] if r["shape"][2] == F]
        out[f"mean_f{F}"] = {k: statistics.mean(r[k] for r in lv) for k in (
            "ms", "kernel_ms", "plain_ms", "library_ms", "bound_ms")
            if all(r[k] is not None for r in lv)}
        print(f"kernel S, levels 0-5 at F = {F}, means: "
              + ", ".join(f"{k} {v:.4f}" for k, v in out[f"mean_f{F}"].items()))

    # (b) the binary cell's rows, one seed: kernel S and the plain loop
    # train the same bytes; 12 launches a tree; cuda:S on every scan record
    c = harness.cell(SCAN_CELL)
    params = harness.params_of(c)
    data = traffic.make(c["config"], c["traffic"], SCAN_SEED, DEVICE)
    B = int(params["max_bin"])
    dtrain = xgbt.QuantileDMatrix(data.train.X, data.train.y, max_bin=B,
                                  device=str(DEVICE))
    dvalid = xgbt.QuantileDMatrix(data.valid.X, data.valid.y, max_bin=B,
                                  ref=dtrain, device=str(DEVICE))
    del data
    per_tree = 2 * int(params["max_depth"])
    tmp = tempfile.mkdtemp(prefix="xgbt_scan_")
    kernel_route = tgrow._seq_cumsum_cuda
    runs = {"kernel": [], "plain": []}
    try:
        for route in ("kernel", "plain", "plain", "kernel"):
            tgrow._seq_cumsum_cuda = (kernel_route if route == "kernel" else
                                      lambda x: tgrow._seq_cumsum_plain(x))
            runs[route].append(_scan_train(dtrain, dvalid, params, ROUNDS))
        tgrow._seq_cumsum_cuda = kernel_route
        prof = _scan_train(dtrain, dvalid, params, ROUNDS, "every=1", tmp)
    finally:
        tgrow._seq_cumsum_cuda = kernel_route
        shutil.rmtree(tmp, ignore_errors=True)
    raw = runs["kernel"][0][0]
    for route, rs in runs.items():
        for r in rs:
            check(r[0] == raw, f"scan (b): {route} model bytes equal kernel "
                  "S's first run")
            check(r[1] == (ROUNDS * per_tree if route == "kernel" else 0),
                  f"scan (b): {route} launched kernel S {r[1]} times")
    check(prof[0] == raw, "scan (b): the profiled run's model bytes equal")
    check(prof[1] == ROUNDS * per_tree, f"scan (b): profiled launches {prof[1]}")
    scans = [b for r in prof[3] for b in r.get("round_detail", {}).get("ops", [])
             if b["op"] == "level_update/scan"]
    check(len(prof[3]) == ROUNDS and len(scans) == ROUNDS * DEPTH and all(
        b["impl"] == "cuda:S" and b["count"] == 2 for b in scans),
        f"scan (b): every level_update/scan record impl cuda:S, 2 a depth "
        f"({sorted({(b['impl'], b['count']) for b in scans})})")
    scan_ms = [sum(b["host_s"] for b in r["round_detail"]["ops"]
                   if b["op"] == "level_update/scan") * 1e3 for r in prof[3]]
    out["train"] = dict(
        cell=SCAN_CELL, seed=SCAN_SEED, rounds=ROUNDS,
        model_sha256=hashlib.sha256(raw).hexdigest(),
        launches=prof[1], launches_per_tree=per_tree,
        round_ms_kernel=[r[2] for r in runs["kernel"]],
        round_ms_plain=[r[2] for r in runs["plain"]],
        level_scan_ms_rounds_1_9=scan_ms[1:])
    del dtrain, dvalid
    torch.cuda.empty_cache()
    t = out["train"]
    print(f"scan (b) {SCAN_CELL} seed {SCAN_SEED}, {ROUNDS} rounds: model "
          f"bytes equal on kernel S and the plain loop (sha256 "
          f"{t['model_sha256'][:16]}); launches {t['launches']} "
          f"({per_tree} a tree); every level_update/scan cuda:S; ms a round "
          f"after round 0: kernel {', '.join(f'{v:.2f}' for v in t['round_ms_kernel'])}"
          f", plain {', '.join(f'{v:.2f}' for v in t['round_ms_plain'])}; "
          f"profiled level_scan ms, rounds 1-9: "
          f"{', '.join(f'{v:.3f}' for v in t['level_scan_ms_rounds_1_9'])}")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"scan: phase {out['phase_s']:.1f} s")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    phase_build()
    X, y, w_gen = _make_data(ROWS + EVAL_ROWS, COLS, 0.0, seed=42)
    Xtr, ytr, Xte, yte = X[:ROWS], y[:ROWS], X[ROWS:], y[ROWS:]
    dlevels = xgbt.DMatrix(Xtr, ytr)
    c64, a64, d64 = phase_level_kernels(dlevels, MAX_BIN)
    c256, a256, d256 = phase_level_kernels(dlevels, DEFAULT_MAX_BIN,
                                           rows_10m=True)
    del dlevels
    torch.cuda.empty_cache()
    b = phase_walk_kernel()
    b["past_2_31"] = phase_walk_past_2_31()
    cat_walk = phase_cat_walk()
    check(hk.can_hoist(hk.onehot_rows(ROWS), COLS, MAX_BIN, DEVICE),
          "max_bin 64: the full one-hot fits the budget")
    bst64, main64 = phase_train(
        "main path", PARAMS, Xtr, ytr, Xte, yte, ROUNDS,
        {"A": 0, "B": ROUNDS, "C": 1, "D": ROUNDS * DEPTH})
    hoisted_trees = heap_trees(bst64, CPU_ROUNDS)
    del bst64
    torch.cuda.empty_cache()  # the bin-64 one-hot (3.2 GB) goes first
    construct = phase_construct_route(Xtr, ytr, hoisted_trees)[0]
    torch.cuda.empty_cache()
    bst256, main256 = phase_train(
        "reference-default path", PARAMS_DEFAULT, Xtr, ytr, Xte, yte, ROUNDS,
        {"A": 0, "B": ROUNDS, "C": 1, "D": ROUNDS * DEPTH})
    check(0 < main256["hoisted_features"] < COLS,
          "max_bin 256 at 1M x 50: a partial hoist")
    trees256 = heap_trees(bst256, CPU_ROUNDS)  # before the bytes materialize
    raw256 = bst256.save_raw()
    serve_walks = phase_serving_walks(bst256, Xte)
    refresh = phase_refresh(bst256, Xte, yte, w_gen)
    del bst256
    torch.cuda.empty_cache()
    phase_card_vs_cpu(Xtr, ytr, Xte)
    surface = phase_train_surface(Xtr, ytr, Xte, yte)
    torch.cuda.empty_cache()
    breadth = phase_grower_breadth(Xtr, ytr, Xte, yte, w_gen)
    torch.cuda.empty_cache()
    multiclass = phase_multiclass(X)
    torch.cuda.empty_cache()
    objectives = phase_objectives(X, y, w_gen)
    torch.cuda.empty_cache()
    lossguide = phase_lossguide(Xtr, ytr, Xte, yte, w_gen)
    torch.cuda.empty_cache()
    dart = phase_dart(Xtr, ytr, Xte, yte)
    torch.cuda.empty_cache()
    forest = phase_random_forest(Xtr, ytr, Xte, yte)
    torch.cuda.empty_cache()
    inert = phase_inert_keys(Xtr, ytr)
    torch.cuda.empty_cache()
    ranking = phase_ranking()
    torch.cuda.empty_cache()
    Xc, yc, types = _make_cat_data(ROWS + EVAL_ROWS, COLS, seed=42)
    Xctr, yctr, Xcte, ycte = Xc[:ROWS], yc[:ROWS], Xc[ROWS:], yc[ROWS:]
    cat_lv, cat_levels = phase_cat_levels(Xctr, yctr, types)
    cat_main, cat_trees = phase_cat_path(Xctr, yctr, Xcte, ycte, types)
    cat_construct = phase_construct_route(
        Xctr, yctr, cat_trees, params=PARAMS_DEFAULT, feature_types=types,
        name="categorical construct route")[0]
    torch.cuda.empty_cache()
    phase_card_vs_cpu(Xctr, yctr, Xcte, feature_types=types,
                      name="categorical card vs CPU")
    torch.cuda.empty_cache()
    shap = phase_shap(Xtr, ytr, Xte, yte, (Xctr, yctr, Xcte, types))
    del Xc, Xctr, Xcte
    torch.cuda.empty_cache()
    gblinear = phase_gblinear(Xtr, ytr, Xte, yte, w_gen)
    torch.cuda.empty_cache()
    sklearn = phase_sklearn(Xtr, ytr, Xte, yte, w_gen)
    torch.cuda.empty_cache()
    approx = phase_approx(Xtr, ytr, Xte, yte, c256)
    torch.cuda.empty_cache()
    local = phase_local(Xtr, ytr, Xte, yte)
    torch.cuda.empty_cache()
    exact = phase_exact()
    torch.cuda.empty_cache()
    wide = phase_wide_bins()
    torch.cuda.empty_cache()
    sparse = phase_sparse()
    torch.cuda.empty_cache()
    extmem = phase_external_memory(Xtr, ytr, Xte, yte)
    torch.cuda.empty_cache()
    distributed = phase_distributed(Xtr, ytr, raw256, main256["logloss"],
                                    trees256)
    torch.cuda.empty_cache()
    rounding = phase_rounding(Xtr, ytr, Xte)
    torch.cuda.empty_cache()
    traced = phase_traced(Xtr, ytr, Xte, yte)
    torch.cuda.empty_cache()
    resilience = phase_resilience(Xtr, ytr, Xte, yte)
    torch.cuda.empty_cache()
    elastic, el_tmp, el_run = phase_elastic(Xtr, ytr)
    cli = phase_cli(Xtr, ytr, Xte, yte, elastic, el_tmp, el_run)
    torch.cuda.empty_cache()
    serving = phase_serving(raw256, Xtr, ytr, Xte, yte, serve_walks)
    fleet = phase_fleet(raw256, Xte, serving)
    torch.cuda.empty_cache()
    pipeline = phase_pipeline(Xtr, ytr, Xte, yte)
    c_api = phase_c_api(Xtr, ytr, Xte, yte, extmem)
    torch.cuda.empty_cache()
    kprof = phase_kernelprof(Xtr, ytr, Xte, yte,
                             pipeline["a"]["syncs_in_a_round"])
    del X, Xtr, Xte
    torch.cuda.empty_cache()
    scan = phase_scan()
    print(json.dumps({
        "levels": {"A_bin64": a64.pop("levels"), "A_bin256": a256.pop("levels"),
                   "D_bin64": d64.pop("levels"),
                   "D_bin256": d256.pop("levels")},
        "kernel_A_bin256": a256, "kernel_C_bin64": c64,
        "kernel_D_bin64": d64, "main_path_bin64": main64,
        "construct_route_launches": construct,
        "reference_default_bin256": main256,
        "categorical_levels": cat_levels, "categorical_path": cat_main,
        "categorical_construct_launches": cat_construct,
        "categorical_walk": cat_walk, "train_surface": surface,
        "grower_breadth": breadth, "multiclass": multiclass,
        "objectives": objectives, "ranking": ranking,
        "lossguide": lossguide, "dart": dart, "random_forest": forest,
        "inert_keys": inert, "shap": shap, "gblinear": gblinear,
        "sklearn": sklearn, "approx": approx, "exact": exact,
        "wide_bins": wide, "local_histmaker": local, "refresh": refresh,
        "sparse": sparse, "external_memory": extmem,
        "distributed": distributed, "rounding": rounding,
        "traced": traced, "resilience": resilience, "elastic": elastic,
        "cli": cli, "serving": {k: v for k, v in serving.items()
                                if k != "kernel_B"}, "fleet": fleet,
        "pipeline": pipeline, "c_api": c_api, "kernelprof": kprof,
        "scan": scan}))
    gbl_launches = {k: sum(v["launches"][k] for v in gblinear.values()
                           if isinstance(v, dict) and "launches" in v)
                    for k in "ABCD"}
    clf = sklearn["classifier"]["launches"]
    rf = sklearn["rf_classifier"]["launches"]
    rank_lv = ranking["level_kernels"]
    for k in (c256, d256, rank_lv["C"], rank_lv["D"]):
        k.pop("B"), k.pop("Fh")
    exact_a = {k: v for k, v in exact["levels_A"].items() if k != "levels"}

    def dist_launches(k):
        """Kernel ``k``'s launches per rank on phase 40's runs."""
        return dict(
            per_rank=[r["launches"][k] for r in distributed["shared"]],
            construct_per_rank=[r["launches"][k]
                                for r in distributed["construct"]],
            sketch_per_rank=[r["launches"][k] for r in distributed["sketch"]],
            lossguide_per_rank=[r["launches"][k]
                                for r in distributed["lossguide"]],
            nccl_world1=distributed["nccl_world1"]["launches"][k])

    def traced_launches(k):
        """Kernel ``k``'s launches on phase 43's runs (each run's, the same
        round by round, traced or not)."""
        return dict(launches=traced["launches"][k],
                    per_round=[r[k] for r in traced["launches_per_round"]])

    def resilience_launches(k):
        """Kernel ``k``'s launches on phase 44's runs: the straight run,
        the process resumed after the SIGKILL (a fresh one-hot, the fill
        walks), the rerun after the chaos abort, and the resume in this
        process after the watchdog abort (the one-hot cached)."""
        return dict(straight=resilience["launches_straight"][k],
                    resumed_process=resilience["launches_resumed"][k],
                    rerun_after_chaos=resilience["launches_rerun"][k],
                    resumed_in_process=resilience[
                        "launches_resumed_here"][k])
    def kernelprof_launches(k):
        """Kernel ``k``'s launches on phase 51's profiled runs, each
        equal to its unprofiled run's."""
        return dict(launches=kprof["launches"][k], per_run={
            n: r["launches"][k] for n, r in kprof["runs"].items()})

    def elastic_launches(k):
        """Kernel ``k``'s launches on phase 45's survivors: (a)'s, one
        process over both generations; (b)'s restarted images (generation
        1 alone)."""
        return dict(survivor_a=elastic["a"]["launches"][k],
                    survivors_b=[elastic["b"]["launches"][r][k]
                                 for r in (0, 1)])
    # the sparse and paged phases' launches, and kernel A per page (mean
    # over the first tree's levels) beside its bound
    sp_l, pg_l = sparse["csr"]["launches"], extmem["paged"]["launches"]
    per_page = [{"rows": lv[0]["rows"], "ms": _mean(lv, "ms"),
                 "plain_ms": _mean(lv, "plain_ms"),
                 "library_ms": _mean(lv, "library_ms"),
                 "bound_ms": _mean(lv, "bound_ms")}
                for lv in zip(*extmem["levels"])]
    # the ranking path's kernels at F = 136: the level check's numbers
    # (kernel against plain, every level of one tree) beside the profiled
    # rounds' device time per level
    rank_k = {k: {x: v[x] for x in ("ms", "kernel_ms", "plain_ms",
                                     "library_ms", "bound_ms", "bound_by",
                                     "max_abs_err")}
              for k, v in rank_lv.items()}
    kernels = [
        dict(name="fused_level", route="cuda",
             source="xgboost_tpu_torch/csrc/hist_level.cu",
             replaces="xgboost_tpu/tree/hist_kernel.py:560",
             launches=cat_construct["A"], categorical=cat_lv["A"],
             ranking=dict(launches=ranking["construct"]["launches"]["A"],
                          kernel_ms_per_level_f136=ranking["construct"][
                              "kernel_A_ms_per_level"],
                          bound_ms_f136=ranking["construct"][
                              "kernel_A_bound_ms"], levels_f136=rank_k["A"]),
             lossguide=dict(launches=lossguide["launches"]["A"],
                            k16=lossguide["child_hist_k16"],
                            k2=lossguide["child_hist_k2"]),
             shap=dict(launches=shap["main"]["launches"]["A"]),
             gblinear=dict(launches=gbl_launches["A"]),
             sklearn=dict(classifier=clf["A"], rf_classifier=rf["A"]),
             approx=dict(launches=approx["launches"]["A"]),
             exact=dict(launches=exact["launches"]["A"],
                        covtype_levels=exact_a,
                        levels_64k=exact["levels_64k"]["A"]),
             wide_bins=wide,
             local_histmaker=dict(launches=local["launches"]["A"],
                                  max_bin_100=rounding[
                                      "local_100_launches"]["A"]),
             refresh=dict(launches=refresh["refresh_leaf_1"]["launches"][
                 "A"]),
             sparse=dict(launches=sp_l["A"], levels_f968=[
                 {k[2:]: v for k, v in lv.items() if k.startswith("A_")}
                 for lv in sparse["levels"]]),
             paged=dict(launches=pg_l["A"], per_page=per_page),
             distributed=dist_launches("A"),
             resilience=resilience_launches("A"),
             elastic=elastic_launches("A"),
             pipeline=dict(launches=pipeline["launches"]["A"]),
             c_api=dict(launches=c_api["launches"]["A"]),
             kernelprof=kernelprof_launches("A"),
             **a64),
        dict(name="predict_margin", route="cuda",
             source="xgboost_tpu_torch/csrc/predict_walk.cu",
             replaces="xgboost_tpu/predictor/__init__.py:299",
             launches=main256["launches"]["B"],
             groups=multiclass["walk_g7"],
             ranking=dict(launches=ranking["launches"]["B"]),
             lossguide=dict(launches=lossguide["launches"]["B"],
                            forest=lossguide["walk"]),
             dart=dict(launches=dart["launches"]["B"]),
             random_forest=dict(launches=forest["launches"]["B"]),
             shap=dict(launches=shap["main"]["launches"]["B"]),
             gblinear=dict(launches=gbl_launches["B"]),
             sklearn=dict(classifier=clf["B"], rf_classifier=rf["B"]),
             approx=dict(launches=approx["launches"]["B"]),
             local_histmaker=dict(launches=local["launches"]["B"]),
             refresh=dict(launches=refresh["refresh_leaf_1"]["launches"][
                 "B"]), sparse=dict(launches=sp_l["B"]),
             paged=dict(launches=pg_l["B"]),
             distributed=dist_launches("B"), traced=traced_launches("B"),
             resilience=resilience_launches("B"),
             elastic=elastic_launches("B"),
             serving=dict(launches=serving["launches"]["B"],
                          stream_dispatches=serving["stream"]["dispatches"],
                          stream_launches=serving["stream"][
                              "kernel_B_launches"],
                          **serving["kernel_B"]),
             fleet=fleet_launches(fleet),
             pipeline=dict(launches=pipeline["launches"]["B"]),
             c_api=dict(launches=c_api["launches"]["B"]),
             kernelprof=kernelprof_launches("B"),
             **b),
        dict(name="build_onehot", route="cuda",
             source="xgboost_tpu_torch/csrc/onehot.cu",
             replaces="xgboost_tpu/tree/hist_kernel.py:378",
             launches=cat_main["launches"]["C"],
             ranking=dict(launches=ranking["launches"]["C"],
                          f136=rank_k["C"]),
             dart=dict(launches=dart["launches"]["C"]),
             random_forest=dict(launches=forest["launches"]["C"]),
             shap=dict(launches=shap["main"]["launches"]["C"]),
             gblinear=dict(launches=gbl_launches["C"]),
             sklearn=dict(classifier=clf["C"], rf_classifier=rf["C"]),
             approx=dict(launches=approx["launches"]["C"],
                         per_round="one one-hot a round, the shape above"),
             exact=dict(launches_64k=exact["card_vs_cpu_launches"]["C"],
                        onehot_64k=exact["levels_64k"]["C"]),
             sparse=dict(launches=sp_l["C"]), paged=dict(launches=pg_l["C"]),
             distributed=dist_launches("C"), traced=traced_launches("C"),
             resilience=resilience_launches("C"),
             elastic=elastic_launches("C"),
             pipeline=dict(launches=pipeline["launches"]["C"]),
             c_api=dict(launches=c_api["launches"]["C"]),
             kernelprof=kernelprof_launches("C"),
             **c256),
        dict(name="hoisted_level", route="cuda",
             source="xgboost_tpu_torch/csrc/hoisted_level.cu",
             replaces="xgboost_tpu/tree/hist_kernel.py:645",
             launches=cat_main["launches"]["D"], categorical=cat_lv["D"],
             ranking=dict(launches=ranking["launches"]["D"],
                          kernel_ms_per_level_f136=ranking["inspection"][
                              "kernel_D_ms_per_level"],
                          bound_ms_f136=ranking["inspection"][
                              "kernel_D_bound_ms"], levels_f136=rank_k["D"]),
             dart=dict(launches=dart["launches"]["D"]),
             random_forest=dict(launches=forest["launches"]["D"]),
             shap=dict(launches=shap["main"]["launches"]["D"]),
             gblinear=dict(launches=gbl_launches["D"]),
             sklearn=dict(classifier=clf["D"], rf_classifier=rf["D"]),
             approx=dict(launches=approx["launches"]["D"]),
             exact=dict(launches_64k=exact["card_vs_cpu_launches"]["D"],
                        levels_64k=exact["levels_64k"]["D"]),
             sparse=dict(launches=sp_l["D"], levels_f968=[
                 {k[2:]: v for k, v in lv.items() if k.startswith("D_")}
                 for lv in sparse["levels"]]),
             paged=dict(launches=pg_l["D"]),
             distributed=dist_launches("D"), traced=traced_launches("D"),
             resilience=resilience_launches("D"),
             elastic=elastic_launches("D"),
             pipeline=dict(launches=pipeline["launches"]["D"]),
             c_api=dict(launches=c_api["launches"]["D"]),
             kernelprof=kernelprof_launches("D"),
             **d256),
        dict(name="seq_cumsum", route="cuda",
             source="xgboost_tpu_torch/csrc/seq_scan.cu",
             replaces=None, launches=scan["train"]["launches"],
             levels_f50=scan[f"mean_f{COLS}"], levels_f136=scan["mean_f136"]),
    ]
    print(json.dumps({"kernels": kernels}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else f"nvidia-smi failed: {smi.stderr.strip()}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def main_kernelprof() -> int:
    """``python3 chip_smoke.py --kernelprof``: phases 1 and 51 alone."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    phase_build()
    X, y, _ = _make_data(ROWS + EVAL_ROWS, COLS, 0.0, seed=42)
    kprof = phase_kernelprof(X[:ROWS], y[:ROWS], X[ROWS:], y[ROWS:])
    print(json.dumps({"kernelprof": kprof}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else f"nvidia-smi failed: {smi.stderr.strip()}")
    return 0


def main_scan() -> int:
    """``python3 chip_smoke.py --scan``: phases 1 and 52 alone."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    phase_build()
    print(json.dumps({"scan": phase_scan()}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else f"nvidia-smi failed: {smi.stderr.strip()}")
    return 0


def main_serving() -> int:
    """``python3 chip_smoke.py --serving``: phases 1, 47 and 48 alone, on
    the reference-default model trained as phase 5 trains it (no eval set:
    the trees are the same)."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    phase_build()
    X, y, _ = _make_data(ROWS + EVAL_ROWS, COLS, 0.0, seed=42)
    Xtr, ytr, Xte, yte = X[:ROWS], y[:ROWS], X[ROWS:], y[ROWS:]
    bst = xgbt.train(PARAMS_DEFAULT, xgbt.DMatrix(Xtr, ytr, device=DEVICE),
                     ROUNDS)
    walks = phase_serving_walks(bst, Xte)
    raw = bst.save_raw()
    del bst
    torch.cuda.empty_cache()
    serving = phase_serving(raw, Xtr, ytr, Xte, yte, walks)
    fleet = phase_fleet(raw, Xte, serving)
    print(json.dumps({"serving": serving, "fleet": fleet,
                      "kernel_B_fleet": fleet_launches(fleet)},
                     default=str))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else f"nvidia-smi failed: {smi.stderr.strip()}")
    return 0


def main_pipeline() -> int:
    """``python3 chip_smoke.py --pipeline``: phases 1 and 49 alone."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    phase_build()
    X, y, _ = _make_data(ROWS + EVAL_ROWS, COLS, 0.0, seed=42)
    pipeline = phase_pipeline(X[:ROWS], y[:ROWS], X[ROWS:], y[ROWS:])
    print(json.dumps({"pipeline": pipeline}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else f"nvidia-smi failed: {smi.stderr.strip()}")
    return 0


def main_c_api() -> int:
    """``python3 chip_smoke.py --c-api``: phases 1 and 50 alone, with
    phase 39 (the paged phase, read through the native ring) before 50 for
    its (e)."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    phase_build()
    X, y, _ = _make_data(ROWS + EVAL_ROWS, COLS, 0.0, seed=42)
    Xtr, ytr, Xte, yte = X[:ROWS], y[:ROWS], X[ROWS:], y[ROWS:]
    extmem = phase_external_memory(Xtr, ytr, Xte, yte)
    torch.cuda.empty_cache()
    c_api = phase_c_api(Xtr, ytr, Xte, yte, extmem)
    print(json.dumps({"c_api": c_api,
                      "external_memory_io": extmem["paged"]["io"]}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else f"nvidia-smi failed: {smi.stderr.strip()}")
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--serving"]:
        sys.exit(main_serving())
    if sys.argv[1:] == ["--pipeline"]:
        sys.exit(main_pipeline())
    if sys.argv[1:] == ["--c-api"]:
        sys.exit(main_c_api())
    if sys.argv[1:] == ["--kernelprof"]:
        sys.exit(main_kernelprof())
    if sys.argv[1:] == ["--scan"]:
        sys.exit(main_scan())
    if len(sys.argv) == 3 and sys.argv[1] == "--resilience-worker":
        sys.exit(_resilience_worker(json.loads(sys.argv[2])))
    if len(sys.argv) == 3 and sys.argv[1] == "--elastic-worker":
        sys.exit(_elastic_worker(json.loads(sys.argv[2])))
    sys.exit(main())
