#!/usr/bin/env bash
# End-to-end demo on a bundled synthetic Indonesian corpus: vocabulary ->
# feature cache -> multitask training -> BLEU evaluation -> single-image
# caption -> serving smoke. Runs on the CPU by default; on a GPU host run it
# with JAX_PLATFORMS=cuda.
#
# Usage: bash examples/run_demo.sh [workdir]
set -euo pipefail
cd "$(dirname "$0")/.."
WORK="${1:-/tmp/icee_demo}"
mkdir -p "$WORK"
export PYTHONPATH="$PWD${PYTHONPATH:+:$PYTHONPATH}"
# demo defaults to the CPU (fast compiles at these toy sizes)
export JAX_PLATFORMS="${JAX_PLATFORMS-cpu}"

DATA="examples/data"
echo "== 1/6 building vocabulary =="
python -m icee_tpu.cli.build_vocab \
    --caption_path "$DATA/train.txt" --vocab_path "$WORK/vocab.pkl" \
    --threshold 1

echo "== 2/6 precomputing image features (random-init backbone: demo) =="
python -m icee_tpu.cli.precompute_features \
    --caption_path "$DATA/train.txt" --image_dir "$DATA/img" \
    --out "$WORK/features.npz" --crop_size 64 --batch_size 4

echo "== 3/6 training the StyleNet multitask regime (3 epochs) =="
python -m icee_tpu.cli.train --trainer multitask --family stylenet \
    --mode happy --vocab_path "$WORK/vocab.pkl" \
    --caption_path "$DATA/train.txt" --val_caption_path "$DATA/train.txt" \
    --happy_path "$DATA/happy.txt" --val_happy_path "$DATA/happy.txt" \
    --sad_path "$DATA/happy.txt" --val_sad_path "$DATA/happy.txt" \
    --angry_path "$DATA/happy.txt" --val_angry_path "$DATA/happy.txt" \
    --feature_cache "$WORK/features.npz" \
    --embed_size 32 --hidden_size 48 --factored_size 48 --dropout 0.0 \
    --max_seq_length 12 --num_epochs 3 --caption_batch_size 8 \
    --language_batch_size 4 --lr_caption 5e-3 --lr_language 5e-3 \
    --model_path "$WORK/models" --log_path "$WORK/out.log" --data_name demo

echo "== 4/6 evaluating BLEU-1..4 on the (training) split =="
python -m icee_tpu.cli.evaluate \
    --checkpoint_path "$WORK/models/HAP_checkpoint_demo" --mode factual \
    --feed_feature \
    --test_path "$DATA/train.txt" --vocab_path "$WORK/vocab.pkl" \
    --feature_cache "$WORK/features.npz" --batch_size 8 \
    --embed_size 32 --hidden_size 48 --factored_size 48 --max_seq_length 12 \
    | tail -4

echo "== 5/6 captioning one image =="
python -m icee_tpu.cli.sample \
    --image "$DATA/img/i1.jpg" --vocab_path "$WORK/vocab.pkl" --mode happy \
    --embed_size 32 --hidden_size 48 --factored_size 48 --max_seq_length 12 \
    --crop_size 64 | tail -1

echo "== 6/6 serving smoke (background server + one request) =="
python - <<'PY'
import json, threading, urllib.request
from icee_tpu.core.backend import start_entry_point
start_entry_point()
from icee_tpu.serve.app import serve
from icee_tpu.serve.config import ServeConfig
from icee_tpu.serve.engine import CaptionEngine
from icee_tpu.core.config import (AttentionDecoderConfig, DecoderConfig,
                                  EncoderConfig)

cfg = ServeConfig(backend_host="127.0.0.1", backend_port=0,
                  image_folder="/tmp/icee_demo/uploads")
engine = CaptionEngine(cfg, smoke_mode=True, image_size=64,
                       dec_cfg=DecoderConfig(vocab_size=8, embed_size=16,
                                             hidden_size=24, factored_size=24,
                                             max_seq_length=8),
                       att_cfg=AttentionDecoderConfig(
                           vocab_size=8, embed_size=16, hidden_size=24,
                           factored_size=24, attention_size=16,
                           max_seq_length=8),
                       enc_cfg=EncoderConfig(embed_size=16))
httpd = serve(cfg, engine=engine)
port = httpd.server_address[1]
threading.Thread(target=httpd.serve_forever, daemon=True).start()
data = open("examples/data/img/i1.jpg", "rb").read()
b = "demoboundary"
body = (f"--{b}\r\nContent-Disposition: form-data; name=\"file\"; "
        f"filename=\"i1.jpg\"\r\nContent-Type: image/jpeg\r\n\r\n"
        ).encode() + data + f"\r\n--{b}--\r\n".encode()
req = urllib.request.Request(
    f"http://127.0.0.1:{port}/generate?mode=happy", data=body, method="POST",
    headers={"Content-Type": f"multipart/form-data; boundary={b}"})
with urllib.request.urlopen(req, timeout=300) as r:
    print("serve response:", json.loads(r.read()))
httpd.shutdown()
PY
echo "== demo complete =="
