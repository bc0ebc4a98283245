"""Model/architecture constants: a copy of
``fvt_tpu/config/model_config.py`` (the upstream project's
``configs.py:9-153``), held equal to it by
``tests/test_torch_copies.py``."""

VIDEO_SIZE = 256  # preprocessing face-crop size

VIDEO_EMBEDDING_DIM = 512
MFCC_DIM = 39
VGGISH_DIM = 128
EGEMAPS_DIM = 23
BERT_DIM = 768
VIDEO_TEMPORAL_DIM = 128
MFCC_TEMPORAL_DIM = 32
VGGISH_TEMPORAL_DIM = 32
EGEMAPS_TEMPORAL_DIM = 32
BERT_TEMPORAL_DIM = 512

# feature-store array trailing shapes, per modality (configs.py:46-59)
FEATURE_DIMENSION = {
    'video': (VIDEO_SIZE, VIDEO_SIZE, 3),
    'cnn': (512,),
    'AU_continuous_label': (12,),
    'EXPR_continuous_label': (1,),
    'VA_continuous_label': (1,),
    'continuous_label': (1,),
    'SSL_continuous_label': (4,),
    'mfcc': (39,),
    'egemaps': (88,),
    'vggish': (128,),
    'logmel': (96, 64),
    'bert': (768,),
    'landmark': (136,),
}

MULTIPLIER = {
    'video': 1, 'cnn': 1, 'AU_continuous_label': 1,
    'EXPR_continuous_label': 1, 'VA_continuous_label': 1,
    'continuous_label': 1, 'mfcc': 1, 'egemaps': 1, 'vggish': 1,
    'logmel': 1, 'bert': 1,
    # beyond upstream: its configs.py:32-44 multiplier omits 'landmark'
    # even though its TCN settings (configs.py:117) define the encoder;
    # the preprocessing's landmark step produces landmark.npy, and this
    # entry makes it a usable CAN/JMT modality
    'landmark': 1,
}

# LFAN per-modality TCN channel stacks (configs.py:61-77)
TCN_CHANNELS = {
    'video': [VIDEO_EMBEDDING_DIM // 2, VIDEO_EMBEDDING_DIM // 2,
              VIDEO_EMBEDDING_DIM // 4, VIDEO_EMBEDDING_DIM // 4],
    'cnn_res50': [VIDEO_EMBEDDING_DIM // 2, VIDEO_EMBEDDING_DIM // 2,
                  VIDEO_EMBEDDING_DIM // 4, VIDEO_EMBEDDING_DIM // 4],
    'mfcc': [MFCC_TEMPORAL_DIM] * 4,
    'vggish': [VGGISH_DIM // 2, VGGISH_DIM // 2,
               VGGISH_DIM // 4, VGGISH_DIM // 4],
    'logmel': [VGGISH_DIM // 2, VGGISH_DIM // 2,
               VGGISH_DIM // 4, VGGISH_DIM // 4],
    'egemaps': [EGEMAPS_TEMPORAL_DIM] * 4,
    'bert': [BERT_TEMPORAL_DIM // 2, BERT_TEMPORAL_DIM // 2,
             BERT_TEMPORAL_DIM // 4, BERT_TEMPORAL_DIM // 4],
}
TCN_KERNEL_SIZE = 5
TCN_DROPOUT = 0.1

# CAN/JMT/MT per-modality TCN settings (configs.py:79-127)
TCN_SETTINGS = {
    'video': {'input_dim': 512, 'channel': [256, 256, 128, 128, 128],
              'kernel_size': 5},
    'cnn': {'input_dim': 512, 'channel': [256, 256, 128, 128],
            'kernel_size': 5},
    'cnn_res50': {'input_dim': 512, 'channel': [256, 256, 128, 128],
                  'kernel_size': 5},
    'vggish': {'input_dim': 128, 'channel': [128, 128, 64, 64],
               'kernel_size': 5},
    'logmel': {'input_dim': 128, 'channel': [128, 128, 64, 64, 64],
               'kernel_size': 5},
    'egemaps': {'input_dim': 88, 'channel': [64, 64, 32, 32],
                'kernel_size': 5},
    'mfcc': {'input_dim': 39, 'channel': [32, 32, 32, 32],
             'kernel_size': 5},
    'landmark': {'input_dim': 136, 'channel': [64, 64, 32, 32],
                 'kernel_size': 5},
    'bert': {'input_dim': 768, 'channel': [256, 256, 128, 128],
             'kernel_size': 5},
}

# LFAN per-modality input embedding dims (model.py:388-390 defaults)
EMBEDDING_DIM = {
    'video': 512, 'bert': 768, 'cnn_res50': 512, 'mfcc': 39,
    'vggish': 128, 'logmel': 128, 'egemaps': 88,
}

# LFAN per-modality TCN output dims (model.py:391-393 defaults)
ENCODER_DIM = {
    'video': 128, 'bert': 128, 'cnn_res50': 128, 'mfcc': 32,
    'vggish': 32, 'logmel': 32, 'egemaps': 32,
}

ATTN_SETTINGS = {'input_dim': 128, 'embedding_dim': 64, 'num_head': 4}

BACKBONE_SETTINGS = {
    'visual_state_dict': 'res50_ir_0.887',
    'audio_state_dict': 'vggish',
}
