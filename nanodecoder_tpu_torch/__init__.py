"""nanodecoder_tpu_torch: the PyTorch + CUDA port of nanodecoder_tpu.

Greedy, beam-search and sampling basecalling of transformer models (lean
or unfolded, MQA/GQA or MHA decoders, exact or int8 cross caches) and of
the recurrent family (biLSTM encoder, input-feed RNN decoder), and their
training, on NVIDIA H100 cards, one process per card:

    import dataclasses
    from nanodecoder_tpu_torch.config import Config
    from nanodecoder_tpu_torch.train.checkpoint import load_params_npz
    from nanodecoder_tpu_torch.decode.translator import Translator

    cfg = Config.from_json(open("bench_results/config.json").read())
    cfg = dataclasses.replace(    # the kernel route; this config says false
        cfg, model=dataclasses.replace(cfg.model, use_pallas=True),
        decode=dataclasses.replace(cfg.decode, use_pallas=True))
    params = load_params_npz("bench_results/flagship_params.npz", cfg.model)
    call = Translator(params, cfg).basecall_read(read)   # device="cuda"

cfg.decode.mode selects greedy or beam search.  The streaming engine
packs the chunks of many reads from fast5/pod5 files into full batches
and writes FASTQ as reads complete:

    from nanodecoder_tpu_torch.decode.engine import StreamingBasecaller
    with open("out.fastq", "w") as out:
        StreamingBasecaller(params, cfg).run(files, out)   # device="cuda"

Training: `train.trainer.Trainer` over `models.model.init_model` params
(or an npz export), with `train.checkpoint.CheckpointManager` for the
port's checkpoint directories.

The CLIs:
`python -m nanodecoder_tpu_torch.cli.basecall --input reads/ --output out.fastq --ckpt x.npz`,
`python -m nanodecoder_tpu_torch.cli.evaluate --ckpt x.npz --simulate N --beam 5`,
`python -m nanodecoder_tpu_torch.cli.preprocess --out shards/ --synthetic N` and
`python -m nanodecoder_tpu_torch.cli.train --ckpt-dir ck/ --data shards/`
(--ckpt takes an .npz export or such a checkpoint directory).

More than one card: the basecall and train CLIs take one process per
card as torchrun starts them
(`torchrun --nproc_per_node N -m nanodecoder_tpu_torch.cli.basecall ...`):
basecalling partitions the files over the ranks and merges their FASTQ
shards on rank 0; training runs data-parallel, the gradients summed over
the ranks (`parallel.mesh.MeshPlan`, which also shards the streaming
engine's batches over the ranks).

Entry points run on the card unless the caller passes device="cpu"
(--cpu for the CLIs).  Read identity and the overlap stitch run in a
small C++ host library (`native/`, built with g++ at first use; numpy
where it cannot be built).  The package imports torch, numpy and the
standard library only, plus h5py (fast5) and pyarrow and flatbuffers
(pod5) where they are installed, and zstandard for pod5's signal.  The
JAX package's orbax checkpoints are read with a second C++ library
(`native/zstd.cpp`: Zstandard and CRC32C) and no other package.
"""

__version__ = "0.1.0"

from nanodecoder_tpu_torch.vocab import DNA_VOCAB, Vocab, make_vocab, vocab_size_for  # noqa: F401,E402
