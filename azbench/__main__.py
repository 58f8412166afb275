import time

STARTED = time.perf_counter()

if __name__ == "__main__":
    import sys

    from azbench.run import main

    sys.exit(main(started=STARTED))
