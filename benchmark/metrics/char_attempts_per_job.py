"""Character passes per character job: the program's ``char.attempts``
count (every pass a job gets: the batched attempt 0, each attempt of the
serial detect-and-regenerate loop, a failed batched job's rerun of attempt
0 included) over its ``char.jobs`` count, summed over the window."""


def read(run):
    jobs = sum(run.phases.get("char.jobs", ()))
    return sum(run.phases.get("char.attempts", ())) / jobs if jobs else None
