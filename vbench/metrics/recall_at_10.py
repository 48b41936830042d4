"""recall_at_10: mean recall@10 of every answer in the window against the
reference's exact top 10 (the judge computes it on the host from the
answers the program returned)."""


def read(run):
    return run.quality["recall"] if run.quality.get("answers") else None
