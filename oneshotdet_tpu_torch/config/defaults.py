"""Default configuration: the port's own copy of the JAX package's tree.

Key names mirror the reference (`maskrcnn_benchmark/config/defaults.py`) so
that reference yaml configs and the repo's ``configs/*.yaml`` load unchanged.
The ``TPU`` section keeps its name so the same yaml files drive both
packages: its static capacities (``NMS_PRE_TOPK``, ``EVAL_ROI_TOPK``,
``STRICT_LEVEL_TOPK``), buckets, ``COMPUTE_DTYPE`` and ``QUANT`` are read by
the port; ``HOST_S2D`` is ignored (the port's stem is a plain 7x7/2 conv),
and a device mesh, which the port has not taken over, raises
``NotImplementedError`` in the engine.
"""

from .node import CfgNode as CN

_C = CN()

# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------
_C.MODEL = CN()
_C.MODEL.RPN_ONLY = False
_C.MODEL.MASK_ON = False
_C.MODEL.FCOS_ON = True          # reference defaults.py:26
_C.MODEL.RETINANET_ON = False
_C.MODEL.KEYPOINT_ON = False
_C.MODEL.DEVICE = "cuda"
_C.MODEL.META_ARCHITECTURE = "GeneralizedRCNN"
_C.MODEL.CLS_AGNOSTIC_BBOX_REG = False
_C.MODEL.FSS_WEIGHT = ""
_C.MODEL.WEIGHT = ""
_C.MODEL.USE_SYNCBN = False

_C.MODEL.BACKBONE = CN()
_C.MODEL.BACKBONE.CONV_BODY = "R-50-FPN-RETINANET"
_C.MODEL.BACKBONE.FREEZE_CONV_BODY_AT = 2   # reference defaults.py:112
_C.MODEL.BACKBONE.USE_GN = False

_C.MODEL.FPN = CN()
_C.MODEL.FPN.USE_GN = False
_C.MODEL.FPN.USE_RELU = False

_C.MODEL.GROUP_NORM = CN()
_C.MODEL.GROUP_NORM.DIM_PER_GP = -1
_C.MODEL.GROUP_NORM.NUM_GROUPS = 32
_C.MODEL.GROUP_NORM.EPSILON = 1e-5

_C.MODEL.RESNETS = CN()
_C.MODEL.RESNETS.NUM_GROUPS = 1
_C.MODEL.RESNETS.WIDTH_PER_GROUP = 64
_C.MODEL.RESNETS.STRIDE_IN_1X1 = True       # Caffe2 convention, defaults.py:280
_C.MODEL.RESNETS.TRANS_FUNC = "BottleneckWithFixedBatchNorm"
_C.MODEL.RESNETS.STEM_FUNC = "StemWithFixedBatchNorm"
_C.MODEL.RESNETS.RES5_DILATION = 1
_C.MODEL.RESNETS.BACKBONE_OUT_CHANNELS = 256 * 4
_C.MODEL.RESNETS.RES2_OUT_CHANNELS = 256
_C.MODEL.RESNETS.STEM_OUT_CHANNELS = 64

# -- FBNet mobile backbone zoo (reference defaults.py:393-424)
_C.MODEL.FBNET = CN()
_C.MODEL.FBNET.ARCH = "default"
_C.MODEL.FBNET.ARCH_DEF = ""                # inline arch (JSON), overrides ARCH
_C.MODEL.FBNET.BN_TYPE = "bn"
_C.MODEL.FBNET.SCALE_FACTOR = 1.0
_C.MODEL.FBNET.WIDTH_DIVISOR = 1
_C.MODEL.FBNET.DW_CONV_SKIP_BN = True
_C.MODEL.FBNET.DW_CONV_SKIP_RELU = True
_C.MODEL.FBNET.DET_HEAD_LAST_SCALE = 1.0    # >0 scale, ==0 skip, <0 same dim
_C.MODEL.FBNET.DET_HEAD_BLOCKS = []
_C.MODEL.FBNET.DET_HEAD_STRIDE = 0          # 0 keeps the arch's stride
_C.MODEL.FBNET.KPTS_HEAD_LAST_SCALE = 0.0
_C.MODEL.FBNET.KPTS_HEAD_BLOCKS = []
_C.MODEL.FBNET.KPTS_HEAD_STRIDE = 0
_C.MODEL.FBNET.MASK_HEAD_LAST_SCALE = 0.0
_C.MODEL.FBNET.MASK_HEAD_BLOCKS = []
_C.MODEL.FBNET.MASK_HEAD_STRIDE = 0
_C.MODEL.FBNET.RPN_HEAD_BLOCKS = 0          # 0 = all blocks in the rpn stage
_C.MODEL.FBNET.RPN_BN_TYPE = ""

# -- RetinaNet one-stage head (reference defaults.py:330-390)
_C.MODEL.RETINANET = CN()
_C.MODEL.RETINANET.NUM_CLASSES = 2
_C.MODEL.RETINANET.ANCHOR_SIZES = (32, 64, 128, 256, 512)
_C.MODEL.RETINANET.ASPECT_RATIOS = (0.5, 1.0, 2.0)
_C.MODEL.RETINANET.ANCHOR_STRIDES = (8, 16, 32, 64, 128)
_C.MODEL.RETINANET.STRADDLE_THRESH = 0
_C.MODEL.RETINANET.OCTAVE = 2.0
_C.MODEL.RETINANET.SCALES_PER_OCTAVE = 3
_C.MODEL.RETINANET.USE_C5 = True            # one-shot config sets False → P6/P7 from P5
_C.MODEL.RETINANET.NUM_CONVS = 4
_C.MODEL.RETINANET.BBOX_REG_WEIGHT = 4.0
_C.MODEL.RETINANET.BBOX_REG_BETA = 0.11
_C.MODEL.RETINANET.PRE_NMS_TOP_N = 12000
_C.MODEL.RETINANET.FG_IOU_THRESHOLD = 0.5
_C.MODEL.RETINANET.BG_IOU_THRESHOLD = 0.4
_C.MODEL.RETINANET.LOSS_ALPHA = 0.25
_C.MODEL.RETINANET.LOSS_GAMMA = 2.0
_C.MODEL.RETINANET.PRIOR_PROB = 0.01
_C.MODEL.RETINANET.INFERENCE_TH = 0.0
_C.MODEL.RETINANET.NMS_TH = 0.4

# -- RPN (dual-parameterized FCOS-as-RPN postprocessing, defaults.py:140-181)
_C.MODEL.RPN = CN()
_C.MODEL.RPN.USE_FPN = False
_C.MODEL.RPN.FG_IOU_THRESHOLD = 0.7
_C.MODEL.RPN.BG_IOU_THRESHOLD = 0.3
_C.MODEL.RPN.BATCH_SIZE_PER_IMAGE = 256
_C.MODEL.RPN.POSITIVE_FRACTION = 0.5
_C.MODEL.RPN.PRE_NMS_TOP_N_TRAIN = 12000
_C.MODEL.RPN.PRE_NMS_TOP_N_TEST = 6000
_C.MODEL.RPN.POST_NMS_TOP_N_TRAIN = 4000
_C.MODEL.RPN.POST_NMS_TOP_N_TEST = 2000
_C.MODEL.RPN.NMS_THRESH = 0.8
_C.MODEL.RPN.MIN_SIZE = 0
_C.MODEL.RPN.FPN_POST_NMS_TOP_N_TRAIN = 4000
_C.MODEL.RPN.FPN_POST_NMS_TOP_N_TEST = 2000
_C.MODEL.RPN.RPN_HEAD = "SingleConvRPNHead"
_C.MODEL.RPN.ANCHOR_SIZES = (32, 64, 128, 256, 512)
_C.MODEL.RPN.ANCHOR_STRIDE = (16,)
_C.MODEL.RPN.ASPECT_RATIOS = (0.5, 1.0, 2.0)
_C.MODEL.RPN.STRADDLE_THRESH = 0

# -- ROI heads (stage-2 matching head, defaults.py:187-233)
_C.MODEL.ROI_HEADS = CN()
_C.MODEL.ROI_HEADS.USE_FPN = False
_C.MODEL.ROI_HEADS.FG_IOU_THRESHOLD = 0.5
_C.MODEL.ROI_HEADS.BG_IOU_THRESHOLD = 0.5
_C.MODEL.ROI_HEADS.BBOX_REG_WEIGHTS = (10.0, 10.0, 5.0, 5.0)
_C.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 128
_C.MODEL.ROI_HEADS.POSITIVE_FRACTION = 0.25
_C.MODEL.ROI_HEADS.SCORE_THRESH = 0.0
_C.MODEL.ROI_HEADS.NMS = 0.5
_C.MODEL.ROI_HEADS.DETECTIONS_PER_IMG = 2000

_C.MODEL.ROI_BOX_HEAD = CN()
_C.MODEL.ROI_BOX_HEAD.FEATURE_EXTRACTOR = "FPN2ROIFeatureExtractor"
_C.MODEL.ROI_BOX_HEAD.PREDICTOR = "FPNPredictor"
_C.MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION = 7
_C.MODEL.ROI_BOX_HEAD.POOLER_SAMPLING_RATIO = 2
_C.MODEL.ROI_BOX_HEAD.POOLER_SCALES = (0.125, 0.0625, 0.03125, 0.015625, 0.0078125)
_C.MODEL.ROI_BOX_HEAD.NUM_CLASSES = 2
_C.MODEL.ROI_BOX_HEAD.MLP_HEAD_DIM = 1024
_C.MODEL.ROI_BOX_HEAD.USE_GN = False
_C.MODEL.ROI_BOX_HEAD.DILATION = 1
_C.MODEL.ROI_BOX_HEAD.CONV_HEAD_DIM = 256
_C.MODEL.ROI_BOX_HEAD.NUM_STACKED_CONVS = 4

# -- Mask head (reference defaults.py:235-251)
_C.MODEL.ROI_MASK_HEAD = CN()
_C.MODEL.ROI_MASK_HEAD.FEATURE_EXTRACTOR = "ResNet50Conv5ROIFeatureExtractor"
_C.MODEL.ROI_MASK_HEAD.PREDICTOR = "MaskRCNNC4Predictor"
_C.MODEL.ROI_MASK_HEAD.POOLER_RESOLUTION = 14
# reference default 0 = adaptive ceil(roi/pooled) grid — dynamic shape; the
# static kernels map 0 -> 2 samples (FPN yamls set 2 anyway)
_C.MODEL.ROI_MASK_HEAD.POOLER_SAMPLING_RATIO = 0
_C.MODEL.ROI_MASK_HEAD.POOLER_SCALES = (1.0 / 16,)
_C.MODEL.ROI_MASK_HEAD.MLP_HEAD_DIM = 1024
_C.MODEL.ROI_MASK_HEAD.CONV_LAYERS = (256, 256, 256, 256)
_C.MODEL.ROI_MASK_HEAD.RESOLUTION = 14
_C.MODEL.ROI_MASK_HEAD.SHARE_BOX_FEATURE_EXTRACTOR = True
_C.MODEL.ROI_MASK_HEAD.POSTPROCESS_MASKS = False
_C.MODEL.ROI_MASK_HEAD.POSTPROCESS_MASKS_THRESHOLD = 0.5
_C.MODEL.ROI_MASK_HEAD.DILATION = 1
_C.MODEL.ROI_MASK_HEAD.USE_GN = False

# -- Keypoint head (reference defaults.py:253-263)
_C.MODEL.ROI_KEYPOINT_HEAD = CN()
_C.MODEL.ROI_KEYPOINT_HEAD.FEATURE_EXTRACTOR = "KeypointRCNNFeatureExtractor"
_C.MODEL.ROI_KEYPOINT_HEAD.PREDICTOR = "KeypointRCNNPredictor"
_C.MODEL.ROI_KEYPOINT_HEAD.POOLER_RESOLUTION = 14
_C.MODEL.ROI_KEYPOINT_HEAD.POOLER_SAMPLING_RATIO = 0
_C.MODEL.ROI_KEYPOINT_HEAD.POOLER_SCALES = (1.0 / 16,)
_C.MODEL.ROI_KEYPOINT_HEAD.MLP_HEAD_DIM = 1024
_C.MODEL.ROI_KEYPOINT_HEAD.CONV_LAYERS = tuple(512 for _ in range(8))
_C.MODEL.ROI_KEYPOINT_HEAD.RESOLUTION = 14
_C.MODEL.ROI_KEYPOINT_HEAD.NUM_CLASSES = 17
_C.MODEL.ROI_KEYPOINT_HEAD.SHARE_BOX_FEATURE_EXTRACTOR = True

# -- FCOS (stage-1 proposal head, defaults.py:297-315)
_C.MODEL.FCOS = CN()
_C.MODEL.FCOS.NUM_CLASSES = 2
_C.MODEL.FCOS.FPN_STRIDES = [8, 16, 32, 64, 128]
_C.MODEL.FCOS.PRIOR_PROB = 0.01
_C.MODEL.FCOS.INFERENCE_TH = 0.0
_C.MODEL.FCOS.NMS_TH = 0.6
_C.MODEL.FCOS.PRE_NMS_TOP_N = 12000
_C.MODEL.FCOS.LOSS_ALPHA = 0.25
_C.MODEL.FCOS.LOSS_GAMMA = 2.0
_C.MODEL.FCOS.CENTER_SAMPLE = False
_C.MODEL.FCOS.POS_RADIUS = 1.5
_C.MODEL.FCOS.LOC_LOSS_TYPE = "iou"
_C.MODEL.FCOS.DENSE_POINTS = 1
_C.MODEL.FCOS.NUM_CONVS = 4

# ---------------------------------------------------------------------------
# Input (defaults.py:48-70)
# ---------------------------------------------------------------------------
_C.INPUT = CN()
_C.INPUT.MIN_SIZE_TRAIN = (800,)
_C.INPUT.SUPP_MIN_SIZE_TRAIN = (300,)
_C.INPUT.MIN_SIZE_RANGE_TRAIN = (-1, -1)
_C.INPUT.MAX_SIZE_TRAIN = 1333
_C.INPUT.SUPP_MAX_SIZE_TRAIN = 600
_C.INPUT.MIN_SIZE_TEST = 800
_C.INPUT.SUPP_MIN_SIZE_TEST = 300
_C.INPUT.MAX_SIZE_TEST = 1333
_C.INPUT.SUPP_MAX_SIZE_TEST = 600
_C.INPUT.PIXEL_MEAN = [102.9801, 115.9465, 122.7717]   # BGR255, defaults.py:64
_C.INPUT.PIXEL_STD = [1.0, 1.0, 1.0]
_C.INPUT.TO_BGR255 = True
_C.INPUT.SUPP_AREA_THRESHOLD = 80 * 80

# ---------------------------------------------------------------------------
# Datasets / dataloader
# ---------------------------------------------------------------------------
_C.DATASETS = CN()
_C.DATASETS.TRAIN = ()
_C.DATASETS.TEST = ()

_C.DATALOADER = CN()
_C.DATALOADER.NUM_WORKERS = 4
# fork-based worker processes (torch DataLoader semantics); False falls back
# to the GIL-bound thread pool (slow for production-size JPEGs)
_C.DATALOADER.USE_PROCESS_WORKERS = True
_C.DATALOADER.SIZE_DIVISIBILITY = 0
_C.DATALOADER.ASPECT_RATIO_GROUPING = False

# ---------------------------------------------------------------------------
# Solver (defaults.py:430-453)
# ---------------------------------------------------------------------------
_C.SOLVER = CN()
_C.SOLVER.MAX_ITER = 40000
_C.SOLVER.BASE_LR = 0.001
_C.SOLVER.BIAS_LR_FACTOR = 2
_C.SOLVER.MOMENTUM = 0.9
_C.SOLVER.WEIGHT_DECAY = 0.0005
_C.SOLVER.WEIGHT_DECAY_BIAS = 0.0
_C.SOLVER.GAMMA = 0.1
_C.SOLVER.STEPS = (30000,)
_C.SOLVER.WARMUP_FACTOR = 1.0 / 3
_C.SOLVER.WARMUP_ITERS = 500
_C.SOLVER.WARMUP_METHOD = "linear"
_C.SOLVER.CHECKPOINT_PERIOD = 1000
_C.SOLVER.IMS_PER_BATCH = 16

# ---------------------------------------------------------------------------
# Test (defaults.py:458-470)
# ---------------------------------------------------------------------------
_C.TEST = CN()
_C.TEST.EXPECTED_RESULTS = []
_C.TEST.EXPECTED_RESULTS_SIGMA_TOL = 4
_C.TEST.IMS_PER_BATCH = 8
_C.TEST.DETECTIONS_PER_IMG = 4000
_C.TEST.LOAD_DIR = ""
_C.TEST.MIN_ITER = 0
_C.TEST.MAX_ITER = 90000

# ---------------------------------------------------------------------------
# Few-shot (the one-shot episodic block, defaults.py:483-543)
# ---------------------------------------------------------------------------
_C.FEW_SHOT = CN()
_C.FEW_SHOT.OUT_MULT_SIM = False
_C.FEW_SHOT.SECOND_STAGE_METHOD = "matching"   # matching | concat | rn
_C.FEW_SHOT.OUT_TRANSFORM = False
_C.FEW_SHOT.TEST_CHEATING = True
_C.FEW_SHOT.CHOOSE_CLOSE = False
# similarity pickle(s) for CHOOSE_CLOSE. The reference hardcodes an absolute
# path template (coco.py:248-250) and keeps this key commented out
# (defaults.py:490); here it is a real key. Accepts a single merged pkl or a
# template with "{cat}". Env var ONESHOT_SUPP_SIM_PKL overrides if set.
_C.FEW_SHOT.SUPP_SIM_FILE = "supp_sim/supp_similarity_merged.pkl"
_C.FEW_SHOT.CHOOSE_SELECTED = False
_C.FEW_SHOT.NUM_SHOT = 1
_C.FEW_SHOT.NEG_SUPPORT = CN()
_C.FEW_SHOT.NEG_SUPPORT.TURN_ON = False
_C.FEW_SHOT.NEG_SUPPORT.NUM_CLS = 1
_C.FEW_SHOT.SAVE_IMAGE = False
# 19 VOC-overlap COCO category ids excluded from training (defaults.py:496)
_C.FEW_SHOT.TRAINING_EXCL_CATS = [1, 2, 3, 4, 5, 6, 7, 9, 15, 16, 17, 18, 19, 20, 40, 57, 59, 61, 63]
_C.FEW_SHOT.TEST_EXCL_CATS = []
_C.FEW_SHOT.STOP_ITER = 100
_C.FEW_SHOT.NMS = "nms"
_C.FEW_SHOT.POOLING = "ROI"
_C.FEW_SHOT.LOAD_PRETRIANED_RPN_ONLY = False
_C.FEW_SHOT.UNLOAD_KEYWORD = ("linz",)
_C.FEW_SHOT.UNTRAINED_KEYWORD = ("linz",)
_C.FEW_SHOT.RESUME = False
_C.FEW_SHOT.ADJUST_LR_ITERS = 10000
_C.FEW_SHOT.ADJUST_LR_DECAY = 0.1
_C.FEW_SHOT.SECOND_STAGE_CLS_LOSS = "ce_loss"  # focal_loss | mse_loss | l1_loss | cxe_loss
_C.FEW_SHOT.SECOND_STAGE_LOSS_ALPHA = 0.25
_C.FEW_SHOT.SUPP_AUG = False
_C.FEW_SHOT.NUM_SUPP_AUG = 1
_C.FEW_SHOT.SUPP_AUG_METHOD = "avg"            # avg | max | conv
_C.FEW_SHOT.ADD_ARTIFICIAL_PROPOSALS = False
_C.FEW_SHOT.SOFT_LABELING = False
_C.FEW_SHOT.SOFT_LABELING_FUNC = "linear"
_C.FEW_SHOT.REVERSE_ORDER = False
_C.FEW_SHOT.SUPP_ROIALIGN = False
_C.FEW_SHOT.GT_PROPOSAL_ONLY = False
_C.FEW_SHOT.LOSS_WEIGHTED = False
_C.FEW_SHOT.TEST_SELECTED_CLS = -1
_C.FEW_SHOT.TEST_SELECTED_SUPP = 0
_C.FEW_SHOT.CYCLIC_TRAINING = False
_C.FEW_SHOT.SIAMESE_BACKBONE = False
_C.FEW_SHOT.MASK_SUPP = False
_C.FEW_SHOT.LINEAR_FUSION = False
_C.FEW_SHOT.TASK = 2

# ---------------------------------------------------------------------------
# Loss selection (defaults.py:548-550)
# ---------------------------------------------------------------------------
_C.LOSS = CN()
_C.LOSS.CLS_LOSS = "BINARY"     # BINARY (sigmoid) | MULTI (softmax)
_C.LOSS.FOCAL_LOSS = "SIGMOID"  # SIGMOID | SOFTMAX

# ---------------------------------------------------------------------------
# Misc
# ---------------------------------------------------------------------------
_C.OUTPUT_DIR = "."
_C.TENSORBOARD_EXPERIMENT = "logs/oneshotdet-tpu"
_C.PATHS_CATALOG = ""

# ---------------------------------------------------------------------------
# Static-shape knobs (no reference equivalent). Padded capacities replace the
# reference's dynamic shapes; resolution buckets replace pad-to-max-in-batch.
# ---------------------------------------------------------------------------
_C.TPU = CN()
_C.TPU.COMPUTE_DTYPE = "bfloat16"      # conv/matmul compute dtype
_C.TPU.PARAM_DTYPE = "float32"
# (h, w) buckets for query images after min/max-side resize, each /32.
_C.TPU.QUERY_BUCKETS = ((832, 1216), (1216, 832))
_C.TPU.SUPP_BUCKET = (416, 416)
_C.TPU.MAX_GT_BOXES = 64               # per-image padded GT capacity
_C.TPU.MASK_RASTER = 56                # per-GT pre-rasterized mask grid (MASK_ON)
_C.TPU.PROPOSALS_PER_IMAGE_TRAIN = 512  # padded stage-1 → stage-2 capacity (train)
_C.TPU.PROPOSALS_PER_IMAGE_TEST = 2000  # = RPN.FPN_POST_NMS_TOP_N_TEST
_C.TPU.NMS_PRE_TOPK = 4096             # per-image cross-level candidate cap fed to NMS
_C.TPU.STRICT_LEVEL_TOPK = False       # True = reference's per-level pre-NMS top-k (slower, bit-parity)
_C.TPU.EVAL_ROI_TOPK = 0               # >0: keep only top-K proposals for stage 2 at eval (opt-in workload cut)
_C.TPU.HOST_S2D = False                # input pipeline emits 2x2-blocked (H/2,W/2,12) pixels for the stem
_C.TPU.MESH_AXES = ("data",)
# per-axis device counts when MESH_AXES is n-D (one -1 allowed), e.g.
# MESH_AXES ("data", "model") + MESH_SHAPE (2, -1): the "model" axis adds
# tensor-parallel heads + spatially partitioned query pixels
# (parallel/sharding.py) on top of data parallelism
_C.TPU.MESH_SHAPE = ()
_C.TPU.REMAT_BACKBONE = False           # jax.checkpoint over ResNet stages
# "int8": dynamic-activation / static-weight int8 conv stack (backbone, FPN,
# FCOS towers) for eval in the JAX package; not ported yet.
_C.TPU.QUANT = "none"

cfg = _C
