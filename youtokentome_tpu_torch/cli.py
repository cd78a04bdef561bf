"""Command-line interface, mirroring the reference `yttm` CLI
(youtokentome/yttm_cli.py): subcommands bpe / encode / decode / vocab,
same options and defaults.  Run as ``python -m youtokentome_tpu_torch.cli``.

Streaming behaviour mirrors BaseEncoder::encode_cli (bpe.cpp:1942-2014):
``--stream`` encodes line-by-line with a flush after each line; the
default batch mode reads stdin in 10 MiB chunks and reports ``bytes
processed`` progress on stderr.  ``--device`` picks where ``bpe`` trains
and ``encode`` merges novel words: ``cuda`` (default) or ``cpu``.
"""

from __future__ import annotations

import sys

import click


@click.group()
def main():
    pass


@click.command()
@click.option("--data", type=click.Path(exists=True), required=True,
              help="Path to the text corpus to train on.")
@click.option("--model", type=click.Path(), required=True,
              help="Where to write the trained model.")
@click.option("--vocab_size", type=click.INT, required=True,
              help="Total id count of the learned vocabulary.")
@click.option("--coverage", type=click.FLOAT, default=1.0, show_default=True,
              help="Fraction of characters the alphabet must cover (rare chars drop out).")
@click.option("--n_threads", type=click.INT, default=-1, show_default=True,
              help="Worker parallelism (-1 = all available).")
@click.option("--pad_id", type=click.INT, default=0, show_default=True,
              help="Id reserved for <PAD>.")
@click.option("--unk_id", type=click.INT, default=1, show_default=True,
              help="Id reserved for <UNK>.")
@click.option("--bos_id", type=click.INT, default=2, show_default=True,
              help="Id reserved for <BOS>.")
@click.option("--eos_id", type=click.INT, default=3, show_default=True,
              help="Id reserved for <EOS>.")
@click.option("--device", type=click.STRING, default=None,
              help="Device that runs the merge rounds: cuda (default) or cpu.")
def bpe(data, model, vocab_size, coverage, n_threads, pad_id, unk_id, bos_id, eos_id, device):
    """Train BPE model."""
    from .api import BPE

    BPE.train(
        data=data,
        model=model,
        vocab_size=vocab_size,
        coverage=coverage,
        n_threads=n_threads,
        pad_id=pad_id,
        unk_id=unk_id,
        bos_id=bos_id,
        eos_id=eos_id,
        device=device,
    )


@click.command()
@click.option("--model", type=click.Path(exists=True), required=True,
              help="Path of a trained model.")
@click.option("--output_type", type=click.Choice(["id", "subword"]), required=True,
              help="'id' or 'subword'.")
@click.option("--n_threads", type=click.INT, default=-1, show_default=True,
              help="Worker parallelism (-1 = all available).")
@click.option("--bos", is_flag=True, help="Prepend the begin-of-sentence token to every line.")
@click.option("--eos", is_flag=True, help="Append the end-of-sentence token to every line.")
@click.option("--reverse", is_flag=True, help="Emit each line's tokens in reverse order.")
@click.option("--stream", is_flag=True,
              help="Line-buffered mode: encode and flush each line as it arrives.")
@click.option("--dropout_prob", type=click.FLOAT, default=0, show_default=True,
              help="BPE-dropout probability (the probability of a merge being dropped)")
@click.option("--device", type=click.STRING, default=None,
              help="Device that merges novel words: cuda (default) or cpu.")
def encode(model, output_type, n_threads, bos, eos, reverse, stream, dropout_prob, device):
    """Encode text to ids or subwords."""
    if n_threads < -1 or n_threads == 0:
        raise ValueError(
            'Invalid value for "--n_threads": must be -1 or positive integer, not "%d"'
            % n_threads
        )
    from .encoder import Encoder
    from .models.state import BPEState

    enc = Encoder(BPEState.load(model), device=device)

    def emit(batch):
        res = enc.encode(batch, output_type, bos, eos, reverse, dropout_prob)
        out = sys.stdout
        for sent in res:
            # reference writes every token followed by a space (utils.h:94-99)
            out.write("".join(f"{t} " for t in sent))
            out.write("\n")

    if stream:
        for line in sys.stdin:
            emit([line.rstrip("\n")])
            sys.stdout.flush()
        return

    batch_limit = 10 * 1024 * 1024  # bpe.cpp:1976
    total = 0
    progress_msg = ""
    fast = output_type == "id" and dropout_prob == 0 and not (bos or eos or reverse)
    if fast:
        # zero-copy path: raw bytes -> C++ tokenizer -> device merge -> C++
        # formatter, or without the C++ tokenizer, raw bytes -> the flat
        # stream pipeline on the device -> formatter
        from .host import fasttok
        from .host.fastio import format_ids

        use_native = fasttok.available()
        if not use_native and enc._zero_is_real:
            # the stream pipeline cannot apply the reference's id-0
            # head-emission quirk (encoder.py): take the batch path
            fast = False
    if fast:
        stdin = sys.stdin.buffer
        stdout = sys.stdout.buffer

        def read_chunks():
            leftover = b""
            while True:
                buf = stdin.read(batch_limit)
                at_eof = len(buf) < batch_limit
                if not buf and not leftover:
                    return
                buf = leftover + buf
                leftover = b""
                if not buf.endswith(b"\n"):
                    while not at_eof and b"\n" not in buf:
                        more = stdin.read(batch_limit)
                        at_eof = len(more) < batch_limit
                        buf += more
                    nl = buf.rfind(b"\n")
                    if nl >= 0 and not at_eof:
                        leftover = buf[nl + 1 :]
                        buf = buf[: nl + 1]
                    elif not buf.endswith(b"\n"):
                        buf += b"\n"  # final unterminated line
                yield buf
                if at_eof and not leftover:
                    return

        if use_native:
            # pipelined: tokenize of chunk k+1 overlaps the device merge
            # of chunk k (Encoder.encode_stream_cli)
            from collections import deque

            sizes = deque()

            def counted():
                for buf in read_chunks():
                    sizes.append(len(buf))
                    yield buf

            for out in enc.encode_stream_cli(counted()):
                stdout.write(out)
                total += sizes.popleft()
                sys.stderr.write("\b" * len(progress_msg))
                progress_msg = f"bytes processed: {total}"
                sys.stderr.write(progress_msg)
        else:
            for buf in read_chunks():
                flat, sentinel = enc.encode_bytes_flat(buf)
                stdout.write(format_ids(flat, sentinel))
                total += len(buf)
                sys.stderr.write("\b" * len(progress_msg))
                progress_msg = f"bytes processed: {total}"
                sys.stderr.write(progress_msg)
        stdout.flush()
        sys.stderr.write("\n")
        return

    while True:
        batch = []
        processed = 0
        for line in sys.stdin:
            line = line.rstrip("\n")
            processed += len(line)
            batch.append(line)
            if processed >= batch_limit:
                break
        if not batch:
            break
        emit(batch)
        total += processed
        sys.stderr.write("\b" * len(progress_msg))
        progress_msg = f"bytes processed: {total}"
        sys.stderr.write(progress_msg)
        if processed < batch_limit:
            break
    sys.stderr.write("\n")


@click.command()
@click.option("--model", type=click.Path(exists=True), required=True,
              help="Path of a trained model.")
@click.option("--ignore_ids", type=click.STRING, required=False,
              help="Comma-separated ids to skip when decoding, e.g. --ignore_ids=1,2,3")
def decode(model, ignore_ids):
    """Decode ids to text."""
    ids = None
    if ignore_ids is not None:
        try:
            ids = [int(x) for x in ignore_ids.split(",")]
        except ValueError:
            raise click.BadParameter(
                "Bad format: expected list of comma-separated integers"
            )
    from .host.fastio import parse_ids
    from .models.state import BPEState
    from .models.vocab import Vocabulary

    vocab = Vocabulary(BPEState.load(model))
    sentinel = -(2**31)
    # line-at-a-time like the reference decode_cli loop (bpe.cpp:2016-2028),
    # with its flush per line on a terminal; into a pipe or a file the
    # writes are buffered (the same bytes)
    out = sys.stdout.buffer
    per_line = sys.stdout.isatty()
    for line in sys.stdin.buffer:
        if not line.endswith(b"\n"):
            line += b"\n"
        flat = parse_ids(line, sentinel)
        out.write(vocab.decode_flat(flat, sentinel, ids))
        if per_line:
            out.flush()
    out.flush()


@click.command()
@click.option("--model", type=click.Path(exists=True), required=True,
              help="Path of a trained model.")
@click.option("--verbose", is_flag=True, help="Also print each token's merge rule.")
def vocab(model, verbose):
    """Print list of learned subwords."""
    from .models.state import BPEState
    from .models.vocab import Vocabulary

    state = BPEState.load(model)
    v = Vocabulary(state)
    n_tokens = max(
        max(v.recipe, default=0), state.special_tokens.max_id()
    ) + 1
    reversed_rules = {z: (x, y) for x, y, z in state.rules} if verbose else {}
    out = sys.stdout
    for i in range(n_tokens):
        token_z = v.id_to_subword(i)
        out.write(f"{i}\t{token_z}")
        if verbose and i in reversed_rules:
            x, y = reversed_rules[i]
            tx = v.id_to_subword(x)
            ty = v.id_to_subword(y)
            used = len(token_z) + 1 + len(tx) + 1 + len(ty)
            out.write("=" + tx + "+" + ty)
            out.write(" " * max(2, 50 - used))
            out.write(f"{x}+{y}")
        out.write("\n")


main.add_command(bpe)
main.add_command(encode)
main.add_command(decode)
main.add_command(vocab)


if __name__ == "__main__":
    main()
