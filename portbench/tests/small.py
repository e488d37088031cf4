"""Small sizes of the benchmark's cells for the CPU tests: the same runner,
reference and comparison, at a width the CPU runs in seconds."""
from portbench.lib import common

SOLVER = {
    "config": {
        "solver": {"backend": "chunked", "per_user_split": True,
                   "max_steps": 30, "lr": 0.05, "tol": 1e-5},
        "network": {**common.config("era-paper-yolov2")["network"],
                    **dict(n_users=24, n_aps=4, n_subchannels=6,
                           area_m=200.0, bandwidth_hz=40e6)}},
    "traffic": {"rate_per_user_s": 2.0},
}

TINY_MAMBA2 = dict(program_config="mamba2-780m", n_layer=2, d_model=256,
                   expand=2, head_dim=32, d_state=32, ngroups=1,
                   conv_width=4, chunk_size=32, vocab_size=512,
                   vocab_pad_multiple=256, tie_embeddings=True,
                   norm_eps=1e-5, residual_in_fp32=False,
                   dtype="bfloat16")
SERVE = {
    "config": {"model": TINY_MAMBA2},
    "traffic": {"prompt_len": 64, "decode_steps": 4, "check_requests": 8},
}
