"""Card-clock milliseconds from the mark at the encoder's forward end to
the mark at the decoder's forward start (to the unit's end mark where
nothing decodes), the mean over units: the device staging, the tables and
the fusion scan, with the gaps between the scan's launches."""


def read(ctx):
    spans = [m.get("dec_start", m.get("end")) - m["enc_end"]
             for m in ctx.marks if "enc_end" in m and "end" in m]
    return 1e3 * sum(spans) / len(spans) if spans else None
