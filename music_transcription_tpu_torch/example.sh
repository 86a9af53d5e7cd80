#!/usr/bin/env bash
# End-to-end workflow script of the PyTorch port, on its CLIs:
#   ./example.sh preprocess   # cache the dataset (background)
#   ./example.sh train        # train on the cache (background)
#   ./example.sh eval         # evaluate the latest run's best checkpoint
#   ./example.sh ast          # AST tier: cache -> encoder pretrain -> decoder -> eval
#   ./example.sh all          # the whole pipeline, with confirmations
# The modes and environment variables are those of the JAX package's
# example.sh. DEVICE (cuda|cpu; empty: each CLI's default, cuda) is passed
# to every CLI; EVAL_EXTRA_ARGS (e.g. --headless) to the eval mode's.
# Sourced, it defines the functions and runs nothing.
set -euo pipefail

# ------------------------- configuration (edit here) -------------------------
ROOT_DIR="${ROOT_DIR:-maestro-v3.0.0}"
N_MELS="${N_MELS:-320}"
CACHE_DIR="${CACHE_DIR:-cached_dataset_mels${N_MELS}}"
MODEL_TYPE="${MODEL_TYPE:-cnn_rnn_large}"
EPOCHS="${EPOCHS:-100}"
BATCH_SIZE="${BATCH_SIZE:-24}"
LR="${LR:-1e-4}"
CHUNK_LENGTH="${CHUNK_LENGTH:-30.0}"
HIDDEN_SIZE="${HIDDEN_SIZE:-512}"
NUM_LAYERS="${NUM_LAYERS:-3}"
OUT_ROOT="${OUT_ROOT:-outputs}"
NUM_WORKERS="${NUM_WORKERS:-8}"
EVAL_SPLIT="${EVAL_SPLIT:-test}"
EVAL_EXTRA_ARGS="${EVAL_EXTRA_ARGS:-}"         # e.g. --headless
PYTHON="${PYTHON:-python}"

# --- AST tier (./example.sh ast) ---
AST_CACHE_DIR="${AST_CACHE_DIR:-cached_ast_c10}"
AST_CHUNK_LENGTH="${AST_CHUNK_LENGTH:-10.0}"
AST_PRETRAIN_EPOCHS="${AST_PRETRAIN_EPOCHS:-60}"
AST_EPOCHS="${AST_EPOCHS:-60}"
AST_BATCH_SIZE="${AST_BATCH_SIZE:-16}"
AST_LR="${AST_LR:-1e-4}"
AST_OUT="${AST_OUT:-outputs/ast}"
AST_EXTRA_ARGS="${AST_EXTRA_ARGS:-}"           # e.g. model geometry overrides
DEVICE="${DEVICE:-}"                           # cuda|cpu (default: cuda)
DEV_ARGS=""
[[ -n "$DEVICE" ]] && DEV_ARGS="--device $DEVICE"

# the package's parent directory, so that `python -m` finds the port
repo="$(cd "$(dirname "${BASH_SOURCE[0]}")/.." && pwd)"
export PYTHONPATH="$repo${PYTHONPATH:+:$PYTHONPATH}"
port="music_transcription_tpu_torch"

confirm() {
    read -r -p "$1 [y/N] " ans
    [[ "$ans" == "y" || "$ans" == "Y" ]]
}

run_preprocess() {
    echo "=== Preprocessing ${ROOT_DIR} -> ${CACHE_DIR} (n_mels=${N_MELS}) ==="
    echo "Note: a full MAESTRO mel cache at n_mels=320 needs tens of GB of disk."
    "$PYTHON" -m "$port.preprocess" \
        --root_dir "$ROOT_DIR" --cache_dir "$CACHE_DIR" \
        --n_mels "$N_MELS" --chunk_length "$CHUNK_LENGTH" \
        --num_workers "$NUM_WORKERS" --verify --background $DEV_ARGS
}

run_train() {
    if [[ ! -d "$CACHE_DIR" ]]; then
        echo "Warning: cache $CACHE_DIR not found; training will fall back to raw loading."
    fi
    echo "=== Training ${MODEL_TYPE} for ${EPOCHS} epochs (bs ${BATCH_SIZE}) ==="
    "$PYTHON" -m "$port.train" \
        --root_dir "$ROOT_DIR" --cache_dir "$CACHE_DIR" \
        --model_type "$MODEL_TYPE" --n_mels "$N_MELS" \
        --hidden_size "$HIDDEN_SIZE" --num_layers "$NUM_LAYERS" \
        --epochs "$EPOCHS" --batch_size "$BATCH_SIZE" --lr "$LR" \
        --chunk_length "$CHUNK_LENGTH" --num_workers "$NUM_WORKERS" \
        --out_root "$OUT_ROOT" --background $DEV_ARGS
}

latest_checkpoint() {
    # newest run dir with a best (fallback: final) checkpoint
    local run best
    run=$(ls -1dt "$OUT_ROOT"/*/ 2>/dev/null | head -1 || true)
    [[ -z "$run" ]] && return 1
    best="${run%/}/checkpoints/model_best.pth"
    [[ -f "$best" ]] || best="${run%/}/checkpoints/model_final.pt"
    [[ -f "$best" ]] || return 1
    echo "$best"
}

run_eval() {
    local ckpt
    if ! ckpt=$(latest_checkpoint); then
        echo "Error: no trained checkpoint found under $OUT_ROOT/"
        exit 1
    fi
    echo "=== Evaluating $ckpt on split '$EVAL_SPLIT' (threshold tuning) ==="
    "$PYTHON" -m "$port.evaluate" \
        --model "$ckpt" --split "$EVAL_SPLIT" \
        --cache_dir "$CACHE_DIR" --root_dir "$ROOT_DIR" \
        --tune_threshold $DEV_ARGS $EVAL_EXTRA_ARGS
}

run_all() {
    confirm "Run preprocessing (background)?" && run_preprocess
    confirm "Run training (background)? (wait for preprocessing to finish first)" && run_train
    confirm "Run evaluation now? (requires a finished training run)" && run_eval
}

run_ast() {
    # frozen pretrained encoder + trained decoder; the encoder is
    # self-pretrained on this corpus' framewise 88-key labels
    echo "=== AST tier: cache -> encoder pretrain -> decoder train (frozen) -> eval ==="
    # 1) waveform+token cache at the AST chunk length (compact: int16 waveforms)
    "$PYTHON" -m "$port.preprocess" \
        --root_dir "$ROOT_DIR" --cache_dir "$AST_CACHE_DIR" \
        --chunk_length "$AST_CHUNK_LENGTH" --waveform --tokenize --compact \
        --num_workers "$NUM_WORKERS" --verify $DEV_ARGS
    # 2) self-pretrain the mel-patch encoder with the framewise 88-key head
    "$PYTHON" -m "$port.train_ast" --pretrain_frames \
        --cache_dir "$AST_CACHE_DIR" --chunk_length "$AST_CHUNK_LENGTH" \
        --epochs "$AST_PRETRAIN_EPOCHS" --batch_size "$AST_BATCH_SIZE" \
        --lr "$AST_LR" --val_split validation --early_stop_patience 10 \
        --save_best_every 5 --run_dir "$AST_OUT/pretrain" $DEV_ARGS $AST_EXTRA_ARGS
    # 3) decoder training on the token objective, pretrained encoder frozen;
    #    model_best selected by generated note-F1, not token CE
    "$PYTHON" -m "$port.train_ast" \
        --cache_dir "$AST_CACHE_DIR" --chunk_length "$AST_CHUNK_LENGTH" \
        --encoder_init "$AST_OUT/pretrain/model_best.pth" --freeze_encoder \
        --epochs "$AST_EPOCHS" --batch_size "$AST_BATCH_SIZE" --lr "$AST_LR" \
        --val_split validation --early_stop_patience 10 \
        --val_note_f1_every 2 --best_metric note_f1 \
        --save_best_every 5 --run_dir "$AST_OUT/decoder" $DEV_ARGS $AST_EXTRA_ARGS
    # 4) held-out note-level F1, greedy + grammar-constrained decoding
    #    (model_final when no best was written, as in very short runs)
    local dec_ckpt="$AST_OUT/decoder/model_best.pth"
    [[ -f "$dec_ckpt" ]] || dec_ckpt="$AST_OUT/decoder/model_final.pth"
    "$PYTHON" -m "$port.evaluate_ast" \
        --model "$dec_ckpt" --cache_dir "$AST_CACHE_DIR" \
        --split "$EVAL_SPLIT" --constrained --headless $DEV_ARGS
}

if [[ "${BASH_SOURCE[0]}" == "$0" ]]; then
    case "${1:-}" in
        preprocess) run_preprocess ;;
        train) run_train ;;
        eval) run_eval ;;
        ast) run_ast ;;
        all) run_all ;;
        *)
            echo "Usage: $0 {preprocess|train|eval|ast|all}"
            echo "Config via env vars: ROOT_DIR N_MELS CACHE_DIR MODEL_TYPE EPOCHS BATCH_SIZE ..."
            echo "AST tier: AST_CACHE_DIR AST_CHUNK_LENGTH AST_EPOCHS AST_BATCH_SIZE AST_LR AST_OUT"
            echo "Device: DEVICE=cuda|cpu; eval flags: EVAL_EXTRA_ARGS"
            exit 1
            ;;
    esac
fi
