# Swin-T (Liu et al., arXiv:2103.14030; microsoft/Swin-Transformer
# configs/swin/swin_tiny_patch4_window7_224.yaml) as the stage-2
# regressor: a copy of scene_regressor_el0_ema.py with three changes of
# the model and its training, each marked "change" below, and its own
# output_dir (change 4), so that its snapshots are not el0's:
#   1. model.name: the Swin-T backbone (tpudet3d_torch only; the JAX
#      package has no Swin);
#   2. model.drop_path_rate 0.2, the published config's stochastic depth;
#   3. optim.wd 0.05, the published config's weight decay (applied to every
#      leaf, as this repo's AdamW does: the published code exempts norms,
#      biases and the position-bias table).
# The comments below are the copied file's.
# Regressor training on coherent synthetic scenes (exact 3D geometry,
# tpudet3d/data/synthetic_scene.py): the stage-2 half of the end-to-end
# protocol validation (benchmarks/validation/protocol_end_to_end.py).
# Same schema as configs/default_config.py, shorter schedule.
# Variant: weight EMA (optim.ema_decay) — the averaged weights are
# validated/served; horizon 1/(1-d)=200 steps (~6 epochs at 32
# steps/epoch), sized to the 1280-step schedule.

data = dict(
    root='',
    resize=(224, 224),
    train_batch_size=128,
    val_batch_size=128,
    max_epochs=40,
    num_workers=4,
    category_list='all',
    normalization=dict(mean=[0.5931, 0.4690, 0.4229],
                       std=[0.2471, 0.2214, 0.2157]),
    synthetic='scene',
    synthetic_length=4096,
    scene_seed=23,
    scene_cache='./output/scene_cache',
)

# change 1 (name) and 2 (drop_path_rate)
model = dict(name='swin_tiny_patch4_window7_224', pretrained=False,
             num_classes=9, bf16=True, load_weights='', resume='',
             drop_path_rate=0.2)

data_parallel = dict(use_parallel=True, num_devices=None)

# change 3 (wd)
optim = dict(name='adam', lr=0.001, momentum=0.9, wd=0.05, betas=(0.9, 0.999),
             rho=0.9, alpha=0.99, nesterov=True, ema_decay=0.995)

scheduler = dict(name='multistepLR', gamma=0.6, exp_gamma=0.975,
                 steps=[22, 30, 36])

loss = dict(names=['l1', 'add_loss', 'cross_entropy'], coeffs=([1., .1], [.2]),
            smoothl1_beta=0.2,
            alwa=dict(use=False, lam_cls=1., lam_reg=1., C=100,
                      compute_std=True),
            w=5.18, eps=1.)

# change 4
output_dir = './output/scene_regressor_swint'

utils = dict(debug_mode=False, random_seeds=5, save_freq=10, print_freq=20,
             debug_steps=100, eval_freq=5)

regime = dict(type='training', vis_only=False)

train_data_pipeline = [('convert_color', dict()),
                       ('horizontal_flip', dict(p=0.4)),
                       ('random_brightness_contrast', dict(p=0.3)),
                       ('random_rotate', dict(angle_limit=10., p=0.4)),
                       ('normalize', data['normalization']),
                       ('to_tensor', dict(img_shape=data['resize']))]

test_data_pipeline = [('convert_color', dict()),
                      ('normalize', data['normalization']),
                      ('to_tensor', dict(img_shape=data['resize']))]
