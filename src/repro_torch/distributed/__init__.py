# the pool's page codecs (memory tiering), numpy host code
