"""Shared vocabulary of the port: a copy of ``fvt_tpu/constants.py``.

Names and values are those of the JAX package (and of the upstream
project's ``constants.py``), so fold files, artifact names and config
snapshots stay interoperable.  ``tests/test_torch_copies.py`` holds
every public name here equal to its original.
"""

# ---------------------------------------------------------------- datasets
MELD = 'MELD'
C_EXPR_DB = 'C-EXPR-DB'
C_EXPR_DB_CHALLENGE = 'C-EXPR-DB-CHALLENGE'

DATASETS = [MELD, C_EXPR_DB, C_EXPR_DB_CHALLENGE]

NUM_CLASSES = {
    MELD: 7,
    C_EXPR_DB: 7,
    C_EXPR_DB_CHALLENGE: 7,
}

# ------------------------------------------------------------------- tasks
CLASSIFICATION = 'CLASSIFICATION'
REGRESSION = 'REGRESSION'

TASKS = [CLASSIFICATION, REGRESSION]

DS_TASK = {
    MELD: CLASSIFICATION,
    C_EXPR_DB: CLASSIFICATION,
    C_EXPR_DB_CHALLENGE: CLASSIFICATION,
}

# ----------------------------------------------------------- fusion models
LFAN = 'LFAN'
CAN = 'CAN'
JMT = 'JMT'
MT = 'MT'

FUSION_METHODS = [LFAN, CAN, JMT, MT]

# -------------------------------------------------------------- optimizers
SGD = 'SGD'
ADAM = 'ADAM'

OPTIMIZERS = [SGD, ADAM]

# ------------------------------------------------------------ lr schedules
STEP = 'STEP'
MULTISTEP = 'MULTISTEP'
MYSTEP = 'MYSTEP'
MYWARMUP = 'MYWARMUP'
COSINE = 'COSINE'
MYCOSINE = 'MYCOSINE'

LR_SCHEDULERS = [STEP, MULTISTEP, MYSTEP, MYWARMUP, COSINE, MYCOSINE]

MAX_MODE = 'MAX'
MIN_MODE = 'MIN'

LR_MODES = [MAX_MODE, MIN_MODE]

# ------------------------------------------------------------------- modes
TRAINING = 'TRAINING'
EVALUATION = 'EVALUATION'

MODES = [TRAINING, EVALUATION]

# ------------------------------------------------------------ image sizes
CROP_SIZE = 224
RESIZE_SIZE = 256

SZ224 = 224
SZ256 = 256
SZ112 = 112

# ------------------------------------------------------------- expressions
SURPRISE = 'Surprise'
FEAR = 'Fear'
DISGUST = 'Disgust'
HAPPINESS = 'Happiness'
SADNESS = 'Sadness'
ANGER = 'Anger'
NEUTRAL = 'Neutral'

FEARFULLY_SURPRISED = 'Fearfully Surprised'
HAPPILY_SURPRISED = 'Happily Surprised'
SADLY_SURPRISED = 'Sadly Surprised'
DISGUSTEDLY_SURPRISED = 'Disgustedly Surprised'
ANGRILY_SURPRISED = 'Angrily Surprised'
SADLY_FEARFUL = 'Sadly Fearful'
SADLY_ANGRY = 'Sadly Angry'
OTHER = 'Other'

EXPRESSIONS = [
    SURPRISE, FEAR, DISGUST, SADNESS, HAPPINESS, ANGER, NEUTRAL,
    FEARFULLY_SURPRISED, HAPPILY_SURPRISED, SADLY_SURPRISED,
    DISGUSTEDLY_SURPRISED, ANGRILY_SURPRISED, SADLY_FEARFUL, SADLY_ANGRY,
    OTHER,
]

# ------------------------------------------------------------------ splits
TRAINSET = 'train'
VALIDSET = 'val'
TESTSET = 'test'

SPLITS = [TRAINSET, VALIDSET, TESTSET]

# -------------------------------------------------------------- modalities
VGGISH = 'vggish'     # audio: precomputed VGGish embeddings (128-d / frame)
VIDEO = 'video'       # raw face crops (H, W, 3) per frame
BERT = 'bert'         # text: BERT token embeddings aligned to frames (768-d)
LOGMEL = 'logmel'     # raw log-mel patches (96, 64) per frame
EXPR = 'EXPR_continuous_label'

MODALITIES = [VGGISH, VIDEO, BERT, EXPR]

# ----------------------------------------------------------------- metrics
MACRO_F1 = 'MACRO_F1'
W_F1 = 'W_F1'
CL_ACC = 'CL_ACC'
CFUSE_MARIX = 'CONFUSION_MATRIX'

METRICS = [MACRO_F1, W_F1, CL_ACC, CFUSE_MARIX]

FRAME_LEVEL = 'FRAME_LEVEL'
VIDEO_LEVEL = 'VIDEO_LEVEL'

EVAL_LEVELS = [FRAME_LEVEL, VIDEO_LEVEL]

# frame -> video aggregation rules
FRM_VOTE = 'FRAMES_VOTE'
FRM_AVG_PROBS = 'FRAMES_AVG_PROBS'
FRM_AVG_LOGITS = 'FRAMES_AVG_LOGITS'

VIDEO_PREDS = [FRM_VOTE, FRM_AVG_PROBS, FRM_AVG_LOGITS]
