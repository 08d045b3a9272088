"""Transcript handling: gentle forced-aligner JSON and the BEAT tab format.

The reference runs gentle (a Kaldi C++ service) to align words to audio
(process/process_beat_txt.py:16-81) and stores per-recording transcripts as
tab-separated '(start)\t(end)\tword' lines. Gentle itself stays a host-side
external tool (SURVEY §2.9); this module reads both of its output formats.
"""
from __future__ import annotations

import json
from typing import List, Tuple

Word = Tuple[float, float, str]


def read_gentle_json(path: str) -> List[Word]:
    """gentle's JSON: {'words': [{'case': 'success', 'start': s, 'end': e,
    'alignedWord'/'word': w}, ...]} -> [(start, end, word)]."""
    with open(path) as f:
        data = json.load(f)
    out: List[Word] = []
    for w in data.get("words", []):
        if w.get("case") != "success":
            continue
        out.append((float(w["start"]), float(w["end"]),
                    w.get("alignedWord") or w.get("word", "")))
    return out


def read_tab_transcript(path: str) -> List[Word]:
    """The reference's Transcripts/*.txt format: 'start\tend\tword' per line
    (make_txt_dataset, make_beat_dataset.py:491-497). A file containing any
    line whose first two tab fields are not floats is treated as RAW text
    (returns []) so callers can fall through to gentle alignment — plain
    prose can legitimately contain tabs."""
    out: List[Word] = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.strip().split("\t")
            if len(parts) < 3:
                continue
            try:
                out.append((float(parts[0]), float(parts[1]), parts[2]))
            except ValueError:
                return []
    return out


def write_tab_transcript(path: str, words: List[Word]) -> None:
    with open(path, "w", encoding="utf-8") as f:
        for (s, e, w) in words:
            f.write(f"{s}\t{e}\t{w}\n")


def normalize_word(word: str) -> str:
    """String normalizer (process/utils/data_utils.py:15): lowercase,
    strip non-alphanumerics except apostrophes."""
    return "".join(ch for ch in word.lower()
                   if ch.isalnum() or ch == "'").strip()


def normalize_string(s: str) -> str:
    """Exact port of the reference's normalize_string
    (process/utils/data_utils.py:5-12, used by the Trinity builder):
    lowercase/trim, isolate , . ! ? with spaces, REMOVE apostrophes
    (shouldn't -> shouldnt), squash every other character to whitespace."""
    import re
    s = s.lower().strip()
    s = re.sub(r"([,.!?])", r" \1 ", s)
    s = re.sub(r"(['])", r"", s)
    s = re.sub(r"[^a-zA-Z0-9,.!?]+", r" ", s)
    return re.sub(r"\s+", r" ", s).strip()


class GentleUnavailable(RuntimeError):
    """Raised when no gentle backend (HTTP server or CLI) is configured or
    reachable; callers treat alignment as skippable (the reference requires
    a local gentle checkout, process_beat_txt.py:12-14)."""


def _words_from_gentle_payload(data: dict) -> List[Word]:
    """Reference assembly semantics (align_words,
    process_beat_txt.py:66-72): successful words keep their own timestamps;
    interior failed words are interpolated from neighbors
    (prev.end, next.start); edge failures are dropped."""
    words = data.get("words", [])
    out: List[Word] = []
    for i, w in enumerate(words):
        if w.get("case") == "success":
            out.append((float(w["start"]), float(w["end"]),
                        w.get("alignedWord") or w.get("word", "")))
        elif 0 < i < len(words) - 1:
            prev, nxt = words[i - 1], words[i + 1]
            if "end" in prev and "start" in nxt:
                out.append((float(prev["end"]), float(nxt["start"]),
                            w.get("word", "")))
    return [w for w in out if w[2]]


def run_gentle(wav_path: str, transcript_text: str,
               server_url: str = None, gentle_cmd: str = None,
               timeout: float = 600.0) -> List[Word]:
    """Drive a gentle forced-alignment run (the orchestration the reference
    does in-process via gentle.ForcedAligner, process_beat_txt.py:62-65).

    server_url: a running gentle HTTP service (its standard
        /transcriptions?async=false API);
    gentle_cmd: path to gentle's align.py (or any CLI printing gentle JSON
        to stdout, invoked as `cmd wav txtfile`).
    Environment fallbacks: $GENTLE_URL / $GENTLE_CMD. Raises
    GentleUnavailable when neither is configured.
    """
    import os
    import subprocess
    import tempfile

    server_url = server_url or os.environ.get("GENTLE_URL")
    gentle_cmd = gentle_cmd or os.environ.get("GENTLE_CMD")

    if server_url:
        import urllib.request
        boundary = "----qpgentle"
        with open(wav_path, "rb") as f:
            audio = f.read()
        parts = []
        parts.append(f"--{boundary}\r\nContent-Disposition: form-data; "
                     f"name=\"transcript\"\r\n\r\n{transcript_text}\r\n"
                     .encode())
        parts.append(f"--{boundary}\r\nContent-Disposition: form-data; "
                     f"name=\"audio\"; filename=\"a.wav\"\r\n"
                     f"Content-Type: audio/wav\r\n\r\n".encode()
                     + audio + b"\r\n")
        parts.append(f"--{boundary}--\r\n".encode())
        body = b"".join(parts)
        req = urllib.request.Request(
            server_url.rstrip("/") + "/transcriptions?async=false",
            data=body, headers={"Content-Type":
                                f"multipart/form-data; boundary={boundary}"})
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                data = json.loads(resp.read().decode())
        except Exception as e:
            raise GentleUnavailable(f"gentle server {server_url}: {e}")
        return _words_from_gentle_payload(data)

    if gentle_cmd:
        import shlex
        with tempfile.NamedTemporaryFile("w", suffix=".txt",
                                         delete=False) as tf:
            tf.write(transcript_text)
            txt_path = tf.name
        try:
            try:
                proc = subprocess.run(
                    shlex.split(gentle_cmd) + [wav_path, txt_path],
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    timeout=timeout, text=True)
            except (subprocess.TimeoutExpired, OSError) as e:
                raise GentleUnavailable(f"gentle cmd {gentle_cmd!r}: {e}")
            if proc.returncode != 0:
                raise GentleUnavailable(
                    f"gentle cmd failed rc={proc.returncode}: "
                    f"{proc.stderr[-500:]}")
            return _words_from_gentle_payload(json.loads(proc.stdout))
        finally:
            os.unlink(txt_path)

    raise GentleUnavailable(
        "no gentle backend: set GENTLE_URL (HTTP service) or GENTLE_CMD "
        "(align.py path), or pass server_url/gentle_cmd")


def align_recording(wav_path: str, transcript_text: str, out_txt: str,
                    **kw) -> List[Word]:
    """run_gentle + write the reference's tab format
    (align_words, process_beat_txt.py:74-81)."""
    words = run_gentle(wav_path, transcript_text, **kw)
    write_tab_transcript(out_txt, words)
    return words
