#!/bin/bash
# The dry-run matrix: the four LM archs at the four assigned shapes and
# bigmeans_paper, on the 16 x 16 and 2 x 16 x 16 fake meshes, the fake
# tensors on the cuda device type; one process an (arch, mesh), then
# launch.report over the records.  On the card:
#
#   bash tools/dryrun_matrix.sh [OUT_DIR]   # one H100
#
# (~4 minutes there; the records land in $out/dryrun_torch.jsonl and the
# tables in $out/report.md).
out=${1:-build/dryrun_matrix}
mkdir -p $out
export PYTHONPATH=src
pids=()
for arch in hymba-1.5b seamless-m4t-medium deepseek-moe-16b qwen3-moe-235b-a22b bigmeans_paper; do
  for mesh in single multi; do
    python3 -m repro_torch.launch.dryrun --arch $arch --mesh $mesh --device-type cuda \
      --json $out/${arch}_${mesh}.jsonl > $out/${arch}_${mesh}.log 2>&1 &
    pids+=($!)
  done
done
rc=0
for p in "${pids[@]}"; do wait $p || rc=1; done
for arch in hymba-1.5b seamless-m4t-medium deepseek-moe-16b qwen3-moe-235b-a22b bigmeans_paper; do
  for mesh in single multi; do cat $out/${arch}_${mesh}.jsonl; done
done > $out/dryrun_torch.jsonl
grep -h "\[dryrun\]" $out/*.log | grep -v done
python3 -m repro_torch.launch.report $out/dryrun_torch.jsonl > $out/report.md
cat $out/report.md
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
exit $rc
